"""The device's idle share at the untraced rate: 1 - (the union of the
device's intervals per chunk in the trace pass) / (the untraced window's
seconds per chunk), rank 0."""


def read(obs):
    t, w = obs["trace"], obs["window"]
    if t["busy_s"] <= 0 or not w["chunks"]:
        return None
    return 1.0 - (t["busy_s"] / t["chunks"]) / (w["seconds"] / w["chunks"])
