"""Auxiliary subsystems of the port: the threefry key operations, and
XLA:CPU's float32 log for the channel LLR prior (`f32math`)."""
