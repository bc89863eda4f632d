"""Nanoseconds per shot of the layer pass's `classify` span: CUDA events around
every call of the pipeline's `classify`, its own time."""


def read(obs):
    layer = obs["layer"]
    secs = (layer["seconds"] or {}).get("classify")
    if not secs or secs <= 0:
        return None
    return 1e9 * secs / layer["shots"]
