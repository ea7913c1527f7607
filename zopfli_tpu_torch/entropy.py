"""Length-limited Huffman codes and entropy cost models.

TPU-native rewrite of the reference's tree machinery
(reference: src/zopfli/katajainen.c (boundary package-merge),
src/zopfli/tree.c:30-101).  The alphabets are tiny (<= 288 symbols,
maxbits <= 15), so exact code construction runs on the host; the *outputs*
(bit-length vectors) feed both the jitted cost models on-chip and the
bitstream emitter.

The implementation here is the classic package-merge algorithm rather than
the reference's lazy chain ("boundary PM") evaluation; both compute exact
optimal length-limited codes.  Tie-breaking mirrors the reference: leaves
are ordered stably by (weight, symbol) and a package wins against an
equal-weight leaf, so the resulting length vectors match the reference's
on ties (which matters for the RLE-encoded tree size downstream).
"""

from __future__ import annotations

import numpy as np


def length_limited_code_lengths(freqs, maxbits: int) -> np.ndarray:
    """Exact minimum-redundancy code lengths with a maximum bit length.

    Mirrors the semantics of the reference ZopfliLengthLimitedCodeLengths
    (katajainen.c:172-262): symbols with zero frequency get length 0; a
    single used symbol gets length 1; the effective depth limit is
    min(maxbits, numsymbols - 1).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n = len(freqs)
    lengths = np.zeros(n, dtype=np.int32)
    used = np.nonzero(freqs)[0]
    numsymbols = len(used)
    if numsymbols == 0:
        return lengths
    if numsymbols == 1:
        lengths[used[0]] = 1
        return lengths
    if numsymbols == 2:
        lengths[used[0]] = 1
        lengths[used[1]] = 1
        return lengths
    if (1 << maxbits) < numsymbols:
        raise ValueError("maxbits too small for alphabet")
    maxbits = min(maxbits, numsymbols - 1)

    # Stable sort of the leaves by (weight, symbol index).
    order = used[np.argsort(freqs[used], kind="stable")]
    leaf_w = freqs[order]

    # Each list item is (weight, leaves) where `leaves` is a tuple of leaf
    # positions (indices into `order`) contained in the item's subtree.
    leaves0 = [(int(leaf_w[i]), (i,)) for i in range(numsymbols)]

    # Package-merge: L rounds of package-then-merge.  A package ties before
    # an equal-weight leaf (reference katajainen.c:90: a new leaf is taken
    # only when the package sum is strictly greater).
    items = leaves0
    for _ in range(maxbits - 1):
        packages = []
        for k in range(0, len(items) - 1, 2):
            w = items[k][0] + items[k + 1][0]
            packages.append((w, items[k][1] + items[k + 1][1]))
        # Merge packages and fresh leaves; packages first on ties.
        merged = []
        pi = li = 0
        while pi < len(packages) or li < numsymbols:
            if pi < len(packages) and (
                li >= numsymbols or packages[pi][0] <= leaves0[li][0]
            ):
                merged.append(packages[pi])
                pi += 1
            else:
                merged.append(leaves0[li])
                li += 1
        items = merged

    counts = np.zeros(numsymbols, dtype=np.int64)
    for w, leaf_ids in items[: 2 * numsymbols - 2]:
        for i in leaf_ids:
            counts[i] += 1
    lengths[order] = counts.astype(np.int32)
    return lengths


def lengths_to_symbols(lengths, maxbits: int) -> np.ndarray:
    """Canonical Huffman code values from code lengths (RFC 1951 3.2.2).

    Semantics of reference ZopfliLengthsToSymbols (tree.c:30-69): symbols
    with length 0 get code 0.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    if np.any(lengths > maxbits):
        raise ValueError("length exceeds maxbits")
    bl_count = np.bincount(lengths, minlength=maxbits + 1).astype(np.int64)
    bl_count[0] = 0
    next_code = np.zeros(maxbits + 1, dtype=np.int64)
    code = 0
    for bits in range(1, maxbits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    # Codes of one length go to its symbols in index order: a stable sort
    # by length gives each symbol its rank among those of its length.
    order = np.argsort(lengths, kind="stable")
    ls = lengths[order]
    symbols = np.zeros(n, dtype=np.int64)
    symbols[order] = next_code[ls] + np.arange(n) - np.searchsorted(ls, ls)
    symbols[lengths == 0] = 0
    return symbols.astype(np.uint32)


def calculate_entropy(counts) -> np.ndarray:
    """Shannon cost-per-symbol in bits with zopfli's conventions.

    Mirrors reference ZopfliCalculateEntropy (tree.c:71-94): a zero count
    is costed as if the count were 1 (log2(sum)); an all-zero histogram
    uses log2(n); tiny negative rounding artifacts clamp to zero.
    """
    counts = np.asarray(counts, dtype=np.float64)
    n = len(counts)
    s = counts.sum()
    log2sum = np.log2(s) if s > 0 else np.log2(n)
    with np.errstate(divide="ignore"):
        bl = log2sum - np.log2(counts)
    bl = np.where(counts == 0, log2sum, bl)
    bl = np.where((bl < 0) & (bl > -1e-5), 0.0, bl)
    return bl


def calculate_bit_lengths(counts, maxbits: int) -> np.ndarray:
    """Reference ZopfliCalculateBitLengths: package-merge, asserting ok."""
    return length_limited_code_lengths(counts, maxbits)
