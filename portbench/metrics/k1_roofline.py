"""K1's least time over its device time: the least time counted from
the input positions the seed scan and every squeeze iteration parse
(roofline.py), the device time summed over K1's kernel by name."""

from portbench import roofline


def read(view):
    t = view.device_s(roofline.is_k1)
    iters = view.config.get("options", {}).get("numiterations")
    if t <= 0 or iters is None:
        return None
    pos = roofline.k1_positions(view.input_bytes, iters)
    return 100.0 * roofline.k1_least_s(pos) / t
