"""Bitstream assembly for DEFLATE output.

TPU-native redesign of the reference's bit-serial writer
(reference: src/zopfli/deflate.c:38-72, AddBit/AddBits/AddHuffmanBits).
Instead of appending one bit at a time, symbols are staged as
(value, nbits) arrays and packed in one vectorized pass:

  bit offset of field i = prefix_sum(nbits)[i]; each field is OR-ed into a
  64-bit word pair at (offset >> 6, offset & 63).

DEFLATE bit order: within a byte, fields fill from the least significant
bit upward; Huffman codes are emitted MSB-first, which is handled by
bit-reversing the code values before staging (`reverse_bits`).

The stream is modeled as segments so stored (btype 0) blocks can demand
byte alignment whose padding depends on the running bit offset:
  ('bits', values, nbits) | ('align',) | ('bytes', payload)
"""

from __future__ import annotations

import numpy as np


def reverse_bits(values, lengths, maxbits: int = 15) -> np.ndarray:
    """Bit-reverse each value within its own length (vectorized).

    A canonical Huffman code must be written MSB-first while DEFLATE packs
    LSB-first; reversing once here lets the packer treat every field
    uniformly.
    """
    v = np.asarray(values, dtype=np.uint32)
    lens = np.asarray(lengths, dtype=np.uint32)
    out = np.zeros_like(v)
    work = v.copy()
    for _ in range(maxbits):
        out = (out << np.uint32(1)) | (work & np.uint32(1))
        work >>= np.uint32(1)
    # out now holds the reversal within maxbits; shift down to the actual
    # length.
    return (out >> (np.uint32(maxbits) - lens)).astype(np.uint32)


class BitStream:
    """Append-only DEFLATE bitstream with one-shot vectorized packing."""

    def __init__(self):
        self._segments = []
        self._nbits = 0

    @property
    def nbits(self) -> int:
        return self._nbits

    @property
    def bit_pointer(self) -> int:
        """Position within the current byte (reference's `bp`)."""
        return self._nbits & 7

    def bits(self, values, nbits) -> None:
        """Stage LSB-first fields. `values`/`nbits` are scalars or arrays."""
        v = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        n = np.atleast_1d(np.asarray(nbits, dtype=np.int64))
        if n.shape != v.shape:
            n = np.broadcast_to(n, v.shape).copy()
        if v.size == 0:
            return
        self._segments.append(("bits", v, n))
        self._nbits += int(n.sum())

    def align_byte(self) -> None:
        """Advance to the next byte boundary with zero bits."""
        pad = (-self._nbits) & 7
        self._segments.append(("align",))
        self._nbits += pad

    def raw_bytes(self, payload: bytes) -> None:
        """Append whole bytes; caller must be byte-aligned (use align_byte)."""
        if self._nbits & 7:
            raise ValueError("raw_bytes requires byte alignment")
        self._segments.append(("bytes", bytes(payload)))
        self._nbits += 8 * len(payload)

    def extend(self, other: "BitStream") -> None:
        """Splice another stream's staged segments onto this one.

        Valid at ANY bit offset: 'align' segments re-resolve their
        padding against the global offset at pack time, which is exactly
        the byte-boundary-skip semantics of stored blocks (RFC 1951
        3.2.4), so independently compressed master blocks concatenate
        into one valid stream (the parallel driver relies on this; the
        reference instead threads its `bp` bit pointer serially,
        deflate.h:50-56).
        """
        self._segments.extend(other._segments)
        # Recompute our total: other's nbits counted its align pads
        # against its own offsets; replay against ours instead.
        nbits = 0
        for seg in other._segments:
            if seg[0] == "align":
                nbits += (-(self._nbits + nbits)) & 7
            elif seg[0] == "bytes":
                nbits += 8 * len(seg[1])
            else:
                nbits += int(seg[2].sum())
        self._nbits += nbits

    def getvalue(self) -> bytes:
        """Pack all staged segments into bytes (final partial byte zero-padded)."""
        total_bits = self._nbits
        nbytes = (total_bits + 7) // 8
        nwords = nbytes // 8 + 2
        words = np.zeros(nwords, dtype=np.uint64)
        offset = 0
        for seg in self._segments:
            kind = seg[0]
            if kind == "align":
                offset = (offset + 7) & ~7
            elif kind == "bytes":
                payload = seg[1]
                assert offset % 8 == 0
                b = np.frombuffer(payload, dtype=np.uint8)
                # OR byte payload into the word array via a uint8 view.
                u8 = words.view(np.uint8)
                start = offset // 8
                u8[start : start + len(b)] |= b
                offset += 8 * len(b)
            else:
                _, v, n = seg
                seg_bits = int(n.sum())
                offs = np.cumsum(n) - n + offset
                widx = (offs >> 6).astype(np.int64)
                shift = (offs & 63).astype(np.uint64)
                lo = v << shift
                inv = np.uint64(64) - shift
                hi = np.where(shift == 0, np.uint64(0),
                              v >> np.where(shift == 0, np.uint64(1), inv))
                np.bitwise_or.at(words, widx, lo)
                np.bitwise_or.at(words, widx + 1, hi.astype(np.uint64))
                offset += seg_bits
        assert offset == total_bits
        if words.dtype.byteorder not in ("<", "=") or not np.little_endian:
            words = words.byteswap()
        return words.view(np.uint8)[:nbytes].tobytes()
