"""The decode's share of its roofline, in %: the operations the layer
pass's shots needed (the iterations they ran, summed per side, times the
side's edges times the operations per edge and iteration,
`yardstick.decode_ops`) over the card's float32 peak, divided by both
sides' decode spans. Bound by operations: a decode reads and writes a few
bytes per edge of shared memory and little of the device's."""


def read(obs):
    ys, layer = obs["yardstick"], obs["layer"]
    secs = layer["seconds"] or {}
    x, z = secs.get("decode_x"), secs.get("decode_z")
    ops = ys.decode_ops(obs["cell"]["decoder"]["type"],
                        obs["shapes"]["edges_x"], obs["shapes"]["edges_z"],
                        layer["iters_x"], layer["iters_z"])
    if not x or not z or not ops:
        return None
    return 100.0 * ops / ys.PEAK_F32_OPS_S / (x + z)
