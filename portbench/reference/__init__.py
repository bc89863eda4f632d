"""The plain reference of the benchmark: the threefry key contract and the
depolarizing channel (`keys`, `channel`), min-sum and BP (`decode`), OSD
(`osd`) and the classification into the event counters (`classify`), in
numpy alone. It imports nothing of the program under test."""
