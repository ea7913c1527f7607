"""Peaks of the card and the least work of the port's kernels.

Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W): HBM3 at 3.35 TB/s,
67 TFLOP/s in float32 outside the tensor cores.  A card held below
700 W runs below them; its power limit is printed beside every run.

K1 (the squeeze's DP scan) is counted from the input alone, so that the
yardstick stays the same whatever tiling, lane count or replica scheme
implements it.  Every input position is parsed once by the seed
program's fixed-cost scan and once per squeeze iteration.  A position's
contract is its KBP sublen breakpoints (length, distance, cost: 3 x 4
bytes each) and its literal cost in, its packed edge and cost out, each
moved once; its operations are 2 float32 adds and a compare for each of
the 256 match lengths it relaxes and 2 for its literal (the arithmetic
of the repository's `chip_smoke._scan_bound`, there counted on padded
tensors).  The bytes bound it: 156 B against 770 operations a position.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

K1_KBP = 12              # breakpoints a position carries (ZT_MAX_BP)
K1_LENGTHS = 256         # match lengths 3..258
K1_BYTES_PER_POS = 3 * 4 * K1_KBP + 4 + 4 + 4
K1_OPS_PER_POS = 3 * K1_LENGTHS + 2


def least_s(nbytes: float, ops: float) -> float:
    """The least time of `nbytes` through HBM and `ops` float32
    operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def k1_positions(input_bytes: int, numiterations: int) -> int:
    """Positions K1 must parse for `input_bytes` of input."""
    return input_bytes * (numiterations + 1)


def k1_least_s(positions: int) -> float:
    return least_s(positions * K1_BYTES_PER_POS,
                   positions * K1_OPS_PER_POS)


K1_NAME = re.compile(r"(^|::)scan_kernel\(|11scan_kernel")


def is_k1(name: str) -> bool:
    """K1's kernel, demangled (`(anonymous namespace)::scan_kernel(...)`
    in csrc/scan.cu) or not; not dp_scan_kernel."""
    return K1_NAME.search(name) is not None
