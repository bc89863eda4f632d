"""Nanoseconds per shot of the layer pass's `channel` span: CUDA events around
every call of the pipeline's `_sample_chunk` (kernel A), its own time."""


def read(obs):
    layer = obs["layer"]
    secs = (layer["seconds"] or {}).get("channel")
    if not secs or secs <= 0:
        return None
    return 1e9 * secs / layer["shots"]
