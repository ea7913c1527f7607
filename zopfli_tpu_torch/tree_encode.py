"""Dynamic Huffman tree header encoding for DEFLATE blocks.

Semantics follow the reference's tree encoder and histogram massaging
(reference: src/zopfli/deflate.c:86-290 PatchDistanceCodesForBuggyDecoders /
EncodeTree / AddDynamicTree / CalculateTreeSize, and
src/zopfli/deflate.c:434-560 OptimizeHuffmanForRle /
TryOptimizeHuffmanForRle), re-expressed in array form.  These run on the
host: the alphabets involved are <= 320 entries, far below any TPU
dispatch threshold, while their *outputs* (bit-length vectors) parameterize
the on-chip cost models.
"""

from __future__ import annotations

import numpy as np

from . import entropy, native
from .emit import BitStream, reverse_bits
from .spec import CL_ORDER, NUM_D, NUM_LL


def patch_distance_codes(d_lengths: np.ndarray) -> np.ndarray:
    """Ensure >= 2 nonzero distance code lengths (buggy-decoder workaround).

    Mirrors reference deflate.c:86-99; only the first 30 symbols are
    considered (the last two are unused by the spec).
    """
    d = d_lengths.copy()
    nz = np.nonzero(d[:30])[0]
    if len(nz) == 0:
        d[0] = d[1] = 1
    elif len(nz) == 1:
        d[1 if d[0] else 0] = 1
    return d


def _rle_encode_lengths(lengths: np.ndarray, use_16: bool, use_17: bool,
                        use_18: bool):
    """Run-length encode the joint ll+dist code-length sequence.

    Returns (rle_symbols, rle_extra, clcounts) where rle_symbols are
    code-length alphabet symbols (0..18) and rle_extra their extra-bit
    values.
    """
    rle = []
    rle_bits = []
    clcounts = np.zeros(19, dtype=np.int64)
    n = len(lengths)
    i = 0
    while i < n:
        symbol = int(lengths[i])
        count = 1
        if use_16 or (symbol == 0 and (use_17 or use_18)):
            j = i + 1
            while j < n and int(lengths[j]) == symbol:
                count += 1
                j += 1
        i += count

        if symbol == 0 and count >= 3:
            if use_18:
                while count >= 11:
                    c2 = min(count, 138)
                    rle.append(18)
                    rle_bits.append(c2 - 11)
                    clcounts[18] += 1
                    count -= c2
            if use_17:
                while count >= 3:
                    c2 = min(count, 10)
                    rle.append(17)
                    rle_bits.append(c2 - 3)
                    clcounts[17] += 1
                    count -= c2

        if use_16 and count >= 4:
            count -= 1  # first occurrence is written literally
            clcounts[symbol] += 1
            rle.append(symbol)
            rle_bits.append(0)
            while count >= 3:
                c2 = min(count, 6)
                rle.append(16)
                rle_bits.append(c2 - 3)
                clcounts[16] += 1
                count -= c2

        clcounts[symbol] += count
        while count > 0:
            rle.append(symbol)
            rle_bits.append(0)
            count -= 1
    return np.array(rle, dtype=np.int64), np.array(rle_bits, dtype=np.int64), clcounts


def encode_tree(ll_lengths: np.ndarray, d_lengths: np.ndarray,
                use_16: bool, use_17: bool, use_18: bool,
                out: BitStream | None = None) -> int:
    """Size in bits of (and optionally emit) one tree-encoding variant."""
    hlit = 29
    while hlit > 0 and ll_lengths[257 + hlit - 1] == 0:
        hlit -= 1
    hdist = 29
    while hdist > 0 and d_lengths[1 + hdist - 1] == 0:
        hdist -= 1
    hlit2 = hlit + 257
    joint = np.concatenate([ll_lengths[:hlit2], d_lengths[: hdist + 1]])

    rle, rle_bits, clcounts = _rle_encode_lengths(joint, use_16, use_17, use_18)

    clcl = entropy.calculate_bit_lengths(clcounts, 7)

    hclen = 15
    while hclen > 0 and clcounts[CL_ORDER[hclen + 4 - 1]] == 0:
        hclen -= 1

    if out is not None:
        clsymbols = entropy.lengths_to_symbols(clcl, 7)
        out.bits([hlit, hdist, hclen], [5, 5, 4])
        out.bits(clcl[CL_ORDER[: hclen + 4]].astype(np.uint64), 3)
        if len(rle):
            lens = clcl[rle].astype(np.uint32)
            codes = reverse_bits(clsymbols[rle], lens)
            ebits = np.where(rle == 16, 2, np.where(rle == 17, 3,
                             np.where(rle == 18, 7, 0)))
            # Interleave huffman code + extra bits per rle entry.
            vals = np.empty(2 * len(rle), dtype=np.uint64)
            nb = np.empty(2 * len(rle), dtype=np.int64)
            vals[0::2] = codes
            nb[0::2] = lens
            vals[1::2] = rle_bits
            nb[1::2] = ebits
            out.bits(vals, nb)

    size = 14 + (hclen + 4) * 3
    size += int((clcl.astype(np.int64) * clcounts).sum())
    size += int(clcounts[16] * 2 + clcounts[17] * 3 + clcounts[18] * 7)
    return size


def calculate_tree_size(ll_lengths, d_lengths) -> int:
    """Exact dynamic-tree header size: best of the 8 RLE variants."""
    best = None
    for i in range(8):
        s = encode_tree(ll_lengths, d_lengths, bool(i & 1), bool(i & 2),
                        bool(i & 4), None)
        if best is None or s < best:
            best = s
    return best


def add_dynamic_tree(ll_lengths, d_lengths, out: BitStream) -> None:
    """Emit the smallest of the 8 tree-encoding variants (the first of
    equal sizes), sized by the native encoder's `tree_sizes`."""
    best = int(np.argmin(native.tree_sizes(ll_lengths, d_lengths)))
    encode_tree(ll_lengths, d_lengths, bool(best & 1), bool(best & 2),
                bool(best & 4), out)


def optimize_huffman_for_rle(counts: np.ndarray) -> np.ndarray:
    """Massage a histogram so its code-length sequence RLE-compresses well.

    Faithful reimplementation of reference deflate.c:434-518.  Collapses
    near-constant strides of counts to their rounded average so the
    resulting Huffman code lengths form longer runs.
    """
    counts = counts.astype(np.int64).copy()
    length = len(counts)
    # 1) Never touch trailing zeros.
    while length > 0 and counts[length - 1] == 0:
        length -= 1
    if length == 0:
        return counts

    # 2) Mark stretches already good for RLE (>=5 zeros / >=7 equal nonzeros).
    good_for_rle = np.zeros(length, dtype=bool)
    symbol = counts[0]
    stride = 0
    for i in range(length + 1):
        if i == length or counts[i] != symbol:
            if (symbol == 0 and stride >= 5) or (symbol != 0 and stride >= 7):
                good_for_rle[i - stride : i] = True
            stride = 1
            if i != length:
                symbol = counts[i]
        else:
            stride += 1

    # 3) Collapse other strides of similar values to their average.
    stride = 0
    limit = counts[0]
    sum_ = 0
    for i in range(length + 1):
        if (i == length or good_for_rle[i]
                or abs(int(counts[i]) - int(limit)) >= 4):
            if stride >= 4 or (stride >= 3 and sum_ == 0):
                count = (sum_ + stride // 2) // stride
                if count < 1:
                    count = 1
                if sum_ == 0:
                    count = 0
                counts[i - stride : i] = count
            stride = 0
            sum_ = 0
            if i < length - 3:
                limit = (counts[i] + counts[i + 1] + counts[i + 2]
                         + counts[i + 3] + 2) // 4
            elif i < length:
                limit = counts[i]
            else:
                limit = 0
        stride += 1
        if i != length:
            sum_ += int(counts[i])
    return counts
