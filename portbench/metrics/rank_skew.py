"""The slowest rank's busy time over the fastest rank's, less 1: a rank's
busy time is its window less the seconds it spent in collectives (the
counters' all-reduce, waiting for the other ranks included, and the stop
decision)."""


def read(obs):
    busy = [r["window"]["seconds"] - r["window"]["wait_s"]
            for r in obs["ranks"]]
    if len(busy) < 2 or min(busy) <= 0:
        return None
    return max(busy) / min(busy) - 1.0
