import pytest

from portbench import roofline, tracing
from portbench.manifest import Manifest


def test_k1_least_time_by_hand():
    # 1,000,000 input bytes at 15 iterations: 16 parses of each byte;
    # a position moves 12 breakpoints x 12 B + 4 B in + 8 B out = 156 B.
    pos = roofline.k1_positions(1_000_000, 15)
    assert pos == 16_000_000
    assert roofline.K1_BYTES_PER_POS == 156
    assert roofline.k1_least_s(pos) == pytest.approx(
        16e6 * 156 / 3.35e12)                     # bytes bound: 0.745 ms
    assert 16e6 * 770 / 67e12 < roofline.k1_least_s(pos)


def test_k1_roofline_reader_by_kernel_name():
    v = tracing.View(calls=1, window_s=1.0, input_bytes=1_000_000,
                     call_s=1.0, config={"options": {"numiterations": 15}},
                     mix={}, device=[
                         (0.0, 0.004,
                          "(anonymous namespace)::scan_kernel(int const*)"),
                         (0.004, 0.0075, "_Z11scan_kernelPKi"),
                         (0.1, 0.5, "(anonymous namespace)::dp_scan_kernel(int)"),
                         (0.5, 0.6, "_Z14dp_scan_kernelPKi")])
    got = Manifest().reader("k1_roofline")(v)
    assert got == pytest.approx(100 * 16e6 * 156 / 3.35e12 / 0.0075)
    v.device = v.device[2:]
    assert Manifest().reader("k1_roofline")(v) is None
