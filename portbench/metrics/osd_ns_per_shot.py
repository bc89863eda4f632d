"""Nanoseconds per shot of the layer pass's `osd` span: CUDA events around
every call of the pipeline's `_apply_osd` (kernel C and the candidates), its own time."""


def read(obs):
    layer = obs["layer"]
    secs = (layer["seconds"] or {}).get("osd")
    if not secs or secs <= 0:
        return None
    return 1e9 * secs / layer["shots"]
