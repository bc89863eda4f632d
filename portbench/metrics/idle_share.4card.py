"""The device's idle share of rank 0 in a run over several cards: as
`idle_share`, 1 - (the union of the device's intervals per chunk in the
trace pass) / (the untraced window's seconds per chunk)."""


def read(obs):
    t, w = obs["trace"], obs["window"]
    if t["busy_s"] <= 0 or not w["chunks"]:
        return None
    return 1.0 - (t["busy_s"] / t["chunks"]) / (w["seconds"] / w["chunks"])
