"""Host syncs per 1000 shots in the untraced window: the program's own
counters (`Cascade.syncs` of both sides, one per cascade stage reached;
`ShotPipeline.osd_syncs`, one per OSD compaction), per card."""


def read(obs):
    w = obs["window"]
    shots = w["shots"] / obs["cell"]["chips"]
    return 1e3 * w["host_syncs"] / shots if shots else None
