"""Nanoseconds per shot of both sides' decodes in the layer pass: CUDA
events around `dec_x.forward` and `dec_z.forward` (the cascade with its
kernel-B launches)."""


def read(obs):
    secs = obs["layer"]["seconds"] or {}
    x, z = secs.get("decode_x"), secs.get("decode_z")
    if not x or not z:
        return None
    return 1e9 * (x + z) / obs["layer"]["shots"]
