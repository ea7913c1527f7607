"""ZopfliPNG's "compress really good" example through optimize_many:
every filter strategy, --lossy_transparent and --lossy_8bit, on RGBA
launcher icons from the benchmark's icon kind, each output held to the
benchmark's alpha-aware check and below its zlib-9 yardstick."""

import numpy as np
import pytest
import torch

from portbench.gen import Item
from portbench.manifest import Manifest
from zopfli_tpu_torch.png import codec
from zopfli_tpu_torch.png.optimize import PNGOptions, optimize_many

torch.set_num_threads(1)

MAN = Manifest()
KIND = MAN.module("inputs", "icons")
FMT = MAN.module("reference/formats", "png_lossy_transparent")
MIX = MAN.traffic("android-launcher")
CONFIG = MAN.config("zopflipng-i500-all-filters")


def _icons():
    """A 48 px ic_launcher and a 72 px ic_launcher_round of one design."""
    d = KIND.design(MIX["apps"][0], np.random.default_rng(5), MIX["icon"])
    out = []
    for size, shape in ((48, "ic_launcher"), (72, "ic_launcher_round")):
        px = KIND.render(d, size, shape, MIX["icon"])
        out.append(Item(f"{shape}.{size}", KIND.save(px, MIX["writer"]),
                        px.size, px))
    return out


def _options(iterations: int, **kw) -> PNGOptions:
    return PNGOptions(**dict(CONFIG["options"], num_iterations=iterations,
                             num_iterations_large=iterations), **kw)


def test_configuration_is_zopflipngs_example():
    o = CONFIG["options"]
    assert o["filter_strategies"] == ["zero", "one", "two", "three", "four",
                                      "minsum", "entropy", "predefined",
                                      "bruteforce"]
    assert (o["num_iterations"], o["num_iterations_large"]) == (500, 500)
    assert o["lossy_transparent"] and o["lossy_8bit"]
    assert not o["auto_filter_strategy"]


@pytest.mark.parametrize("engine,iterations,count", [
    ("native", 60, 2), ("device", 1, 1)])
def test_outputs_pass_the_alpha_aware_check_and_beat_zlib9(engine,
                                                           iterations,
                                                           count):
    """The configuration's options at 60 iterations on the host engine,
    and through the device engine on the CPU at one iteration (the fused
    loop's CPU path costs seconds an iteration): RGBA kept (over 256
    colours), the hidden RGB rewritten, every output passing the check
    and smaller than the yardstick."""
    items = _icons()[:count]
    outs = optimize_many([i.raw for i in items],
                         _options(iterations, engine=engine, device="cpu"))
    for item, out in zip(items, outs):
        assert FMT.judge(out, item) is None
        assert len(out) < FMT.zlib9_size(item)
        assert out[25] == 6                          # color type
        rgba = codec.decode(out)[0]
        clear = item.expect[:, :, 3] == 0
        assert not np.array_equal(rgba[clear, :3], item.expect[clear, :3])
