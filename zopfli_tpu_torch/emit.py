"""Bitstream assembly for DEFLATE output.

Redesign of the reference's bit-serial writer (reference:
src/zopfli/deflate.c:38-72, AddBit/AddBits/AddHuffmanBits).  Emission
stages segments; `getvalue` packs them in one pass of the native bit
writer (native.put_fields, native.put_lz77), LSB-first from the running
bit offset into one zero-initialised byte buffer.

DEFLATE bit order: within a byte, fields fill from the least significant
bit upward; Huffman codes are emitted MSB-first, which is handled by
bit-reversing the code values before staging (`reverse_bits`).

The stream is modeled as segments so stored (btype 0) blocks can demand
byte alignment whose padding depends on the running bit offset:
  ('bits', values, nbits) | ('align',) | ('bytes', payload)
  | ('lz77', litlens, dists, ll_codes, ll_lengths, d_codes, d_lengths,
     nbits)
A 'lz77' segment is a block's symbol payload: the store's symbols as they
are and the block's code tables, with its exact bit count.

PACKED counts the bits each pack wrote, the payload's ('lz77') and the
fields' ('bits'); payload_bits / (payload_bits + field_bits) is the
share of the streams that the payload pass wrote.
"""

from __future__ import annotations

import numpy as np

from . import native
from .utils.counters import bump
from .utils.logging import span

PACKED = {"payload_bits": 0, "field_bits": 0}


# _REV8[b]: the byte b with its 8 bits in reverse order.
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                 dtype=np.uint32)


def reverse_bits(values, lengths, maxbits: int = 15) -> np.ndarray:
    """Bit-reverse each value within its own length (vectorized).

    A canonical Huffman code must be written MSB-first while DEFLATE packs
    LSB-first; reversing once here lets the packer treat every field
    uniformly.  Bits of a value at or above `maxbits` (at most 16) are
    dropped.
    """
    if maxbits > 16:
        raise ValueError("reverse_bits handles at most 16 bits")
    v = np.asarray(values, dtype=np.uint32) & np.uint32((1 << maxbits) - 1)
    lens = np.asarray(lengths, dtype=np.uint32)
    # The 16-bit reversal from two byte reversals, shifted down to the
    # value's own length.
    rev16 = ((_REV8[v & np.uint32(0xFF)] << np.uint32(8))
             | _REV8[v >> np.uint32(8)])
    return (rev16 >> (np.uint32(16) - lens)).astype(np.uint32)


class BitStream:
    """Append-only DEFLATE bitstream, packed in one pass at the end."""

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

    def lz77(self, litlens, dists, ll_codes, ll_lengths, d_codes, d_lengths,
             nbits: int) -> None:
        """Stage a block's symbol payload (reference AddLZ77Data).

        litlens/dists: the block's symbols, kept as given (int32 slices of
        a store); ll_codes/ll_lengths (288) and d_codes/d_lengths (32):
        the block's bit-reversed codes and their lengths; nbits: the
        payload's exact size, which the pack checks.
        """
        if len(litlens) == 0:
            return
        self._segments.append(("lz77", litlens, dists, ll_codes, ll_lengths,
                               d_codes, d_lengths, int(nbits)))
        self._nbits += int(nbits)

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
            elif seg[0] == "lz77":
                nbits += seg[7]
            else:
                nbits += int(seg[2].sum())
        self._nbits += nbits

    def getvalue(self) -> bytes:
        """Pack all staged segments into bytes (final partial byte zero-padded)."""
        with span("zt.pack"):
            return self._pack()

    def _pack(self) -> bytes:
        nbytes = (self._nbits + 7) // 8
        # The native writer stores 8 bytes at a time: 8 spare at the end.
        buf = np.zeros(nbytes + 8, dtype=np.uint8)
        offset = 0
        payload_bits = field_bits = 0
        fields = []  # a run of 'bits' segments, written in one call
        for seg in self._segments:
            kind = seg[0]
            if kind == "bits":
                fields.append(seg)
                continue
            if fields:
                end = _put_fields(buf, offset, fields)
                field_bits += end - offset
                offset, fields = end, []
            if kind == "align":
                offset = (offset + 7) & ~7
            elif kind == "bytes":
                assert offset % 8 == 0
                start = offset // 8
                buf[start : start + len(seg[1])] = np.frombuffer(seg[1],
                                                                 np.uint8)
                offset += 8 * len(seg[1])
            else:
                end = native.put_lz77(buf, offset, *seg[1:7])
                if end != offset + seg[7]:
                    raise RuntimeError(
                        f"a symbol payload wrote {end - offset} bits where"
                        f" it was staged with {seg[7]}")
                payload_bits += seg[7]
                offset = end
        if fields:
            end = _put_fields(buf, offset, fields)
            field_bits += end - offset
            offset = end
        assert offset == self._nbits
        bump(PACKED, "payload_bits", payload_bits)
        bump(PACKED, "field_bits", field_bits)
        return buf[:nbytes].tobytes()


def _put_fields(buf: np.ndarray, offset: int, fields) -> int:
    """Write a run of 'bits' segments from `offset`; the offset after it."""
    if len(fields) == 1:
        return native.put_fields(buf, offset, fields[0][1], fields[0][2])
    return native.put_fields(buf, offset,
                             np.concatenate([f[1] for f in fields]),
                             np.concatenate([f[2] for f in fields]))
