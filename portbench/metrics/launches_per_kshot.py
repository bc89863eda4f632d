"""Device kernels per 1000 shots in the trace pass: every kernel the
profiler saw, the port's own and torch's, on rank 0's card."""


def read(obs):
    t = obs["trace"]
    return 1e3 * t["kernels"] / t["shots"] if t["kernels"] else None
