"""The port's bitstream writer (emit.BitStream packed by the native bit
writer) against the JAX package's numpy packer.

Random segment sequences, `extend()` at every bit offset and a pickle
round trip of the segments (as compress_multihost all-gathers them) give
the same bytes and the same `nbits` through both packages' BitStream; a
block's symbol payload staged by the port's `_emit_lz77_data` packs to
the bytes of the JAX package's `_emit_lz77_data` + `getvalue`, at every
length and distance code, for fixed and dynamic trees, at every bit
offset.
"""

import importlib
import pickle

import numpy as np
import pytest

from zopfli_tpu import emit as jemit
from zopfli_tpu.lz77 import LZ77Store as JStore
from zopfli_tpu_torch import blocks, emit, native, spec
from zopfli_tpu_torch.lz77 import LZ77Store

# The packages export a function `deflate` under the modules' name.
jdeflate = importlib.import_module("zopfli_tpu.deflate")
deflate = importlib.import_module("zopfli_tpu_torch.deflate")


def _random_ops(rng, n_ops):
    """A list of staging calls both packages' BitStream accept."""
    ops = []
    for _ in range(n_ops):
        k = rng.integers(0, 4)
        if k == 0:
            width = int(rng.integers(0, 17))
            ops.append(("bits", int(rng.integers(0, 1 << width)), width))
        elif k == 1:
            m = int(rng.integers(1, 40))
            widths = rng.integers(0, 17, m)
            values = rng.integers(0, 1 << widths)
            ops.append(("bits", values.astype(np.uint64), widths))
        elif k == 2:
            ops.append(("align",))
        else:
            payload = rng.integers(0, 256, int(rng.integers(0, 12)),
                                   dtype=np.uint8).tobytes()
            ops.append(("bytes", payload))
    return ops


def _apply(stream, ops):
    for op in ops:
        if op[0] == "bits":
            stream.bits(op[1], op[2])
        elif op[0] == "align":
            stream.align_byte()
        else:
            stream.align_byte()
            stream.raw_bytes(op[1])
    return stream


def _unpickled(stream, cls):
    """A stream rebuilt from the pickled segments, as compress_multihost
    rebuilds each rank's parts."""
    part = cls()
    part._segments = pickle.loads(pickle.dumps(stream._segments))
    out = cls()
    out.extend(part)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_segments_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ops = _random_ops(rng, 60)
    ours = _apply(emit.BitStream(), ops)
    ref = _apply(jemit.BitStream(), ops)
    assert ours.nbits == ref.nbits
    assert ours.getvalue() == ref.getvalue()
    again = _unpickled(ours, emit.BitStream)
    assert again.nbits == ref.nbits
    assert again.getvalue() == ref.getvalue()


def _symbols(kind):
    """(litlens, dists) of one block of the given kind."""
    if kind == "every_length":
        lens = np.arange(3, 259)
        lit = np.concatenate([np.arange(256), lens])
        dst = np.concatenate([np.zeros(256, int), 1 + (lens * 37) % 32768])
    elif kind == "every_distance":
        base = spec.DIST_SYM_BASE[:30].astype(int)
        last = np.append(base[1:] - 1, 32768)
        dst = np.concatenate([base, last, [32768, 1]])
        lit = 3 + np.arange(len(dst)) % 256
    elif kind == "one_literal":
        lit, dst = np.array([65]), np.array([0])
    elif kind == "empty":
        lit, dst = np.zeros(0, int), np.zeros(0, int)
    else:  # "mixed": random literals and matches
        rng = np.random.default_rng(7)
        n = 3000
        is_match = rng.random(n) < 0.4
        lit = np.where(is_match, rng.integers(3, 259, n),
                       rng.integers(0, 256, n))
        dst = np.where(is_match, rng.integers(1, 32769, n), 0)
    return lit.astype(np.int32), dst.astype(np.int32)


def _stores(kind):
    lit, dst = _symbols(kind)
    nbytes = int(np.where(dst == 0, 1, lit).sum())
    data = np.zeros(max(nbytes, 1), np.uint8)
    return LZ77Store(data, lit, dst), JStore(data, lit, dst)


def _lengths(store, btype):
    if btype == 1:
        return spec.fixed_tree_lengths()
    if store.size == 0:
        return blocks.get_dynamic_lengths(_stores("one_literal")[0], 0, 1)[1:]
    return blocks.get_dynamic_lengths(store, 0, store.size)[1:]


@pytest.mark.parametrize("btype", [1, 2])
@pytest.mark.parametrize("kind", ["every_length", "every_distance",
                                  "one_literal", "empty", "mixed"])
def test_payload_equals_jax(kind, btype):
    ours_store, ref_store = _stores(kind)
    ll, d = _lengths(ours_store, btype)
    ours, ref = emit.BitStream(), jemit.BitStream()
    ours.bits(5, 3)
    ref.bits(5, 3)
    deflate._emit_lz77_data(ours_store, 0, ours_store.size, ll, d, ours)
    jdeflate._emit_lz77_data(ref_store, 0, ref_store.size, ll, d, ref)
    assert ours.nbits == ref.nbits
    assert ours.getvalue() == ref.getvalue()
    # The payload is one segment, sized exactly, and no numpy field array.
    kinds = [seg[0] for seg in ours._segments]
    assert kinds == ["bits"] + (["lz77"] if ours_store.size else [])


@pytest.mark.parametrize("btype", [1, 2])
@pytest.mark.parametrize("kind", ["every_length", "every_distance",
                                  "one_literal", "mixed"])
def test_whole_block_equals_jax(kind, btype):
    ours_store, ref_store = _stores(kind)
    ours, ref = emit.BitStream(), jemit.BitStream()
    opts = deflate.Options(device="cpu")
    deflate.add_lz77_block(opts, btype, True, ours_store, 0, ours_store.size,
                           ours)
    jdeflate.add_lz77_block(jdeflate.Options(), btype, True, ref_store, 0,
                            ref_store.size, ref)
    assert ours.nbits == ref.nbits
    assert ours.getvalue() == ref.getvalue()


@pytest.mark.parametrize("offset", range(8))
def test_payload_at_every_bit_offset(offset):
    ours_store, ref_store = _stores("mixed")
    ll, d = _lengths(ours_store, 2)
    lo, hi = 100, 2500
    ours, ref = emit.BitStream(), jemit.BitStream()
    for s in (ours, ref):
        s.bits(np.full(offset, 1, np.uint64), 1)
    deflate._emit_lz77_data(ours_store, lo, hi, ll, d, ours)
    jdeflate._emit_lz77_data(ref_store, lo, hi, ll, d, ref)
    for s in (ours, ref):
        s.bits(0b101, 3)
    assert ours.nbits == ref.nbits
    assert ours.getvalue() == ref.getvalue()


@pytest.mark.parametrize("offset", range(8))
def test_extend_at_every_bit_offset(offset):
    """A part with a payload, fields, an alignment and raw bytes spliced
    on at each bit offset; also from its pickled segments."""
    ours_store, ref_store = _stores("mixed")
    ll, d = _lengths(ours_store, 2)
    rng = np.random.default_rng(100 + offset)
    ops = _random_ops(rng, 20)

    def build(stream_cls, emit_data, store):
        head = stream_cls()
        head.bits(np.full(offset, 1, np.uint64), 1)
        part = stream_cls()
        part.bits(3, 2)
        emit_data(store, 10, 900, ll, d, part)
        _apply(part, ops)
        emit_data(store, 900, 1000, ll, d, part)
        part.bits(1, 1)
        return head, part

    ours_head, ours_part = build(emit.BitStream, deflate._emit_lz77_data,
                                 ours_store)
    ref_head, ref_part = build(jemit.BitStream, jdeflate._emit_lz77_data,
                               ref_store)
    ref_head.extend(ref_part)
    want = ref_head.getvalue()

    ours_head.extend(ours_part)
    assert ours_head.nbits == ref_head.nbits
    assert ours_head.getvalue() == want

    head, _ = build(emit.BitStream, deflate._emit_lz77_data, ours_store)
    part = emit.BitStream()
    part._segments = pickle.loads(pickle.dumps(ours_part._segments))
    head.extend(part)
    assert head.nbits == ref_head.nbits
    assert head.getvalue() == want


def test_packed_counts_payload_and_field_bits():
    ours_store, _ = _stores("mixed")
    ll, d = spec.fixed_tree_lengths()
    out = emit.BitStream()
    out.bits([1, 2], [3, 5])
    deflate._emit_lz77_data(ours_store, 0, 500, ll, d, out)
    payload = out.nbits - 8
    out.align_byte()
    out.raw_bytes(b"xyz")
    before = dict(emit.PACKED)
    out.getvalue()
    assert emit.PACKED["payload_bits"] - before["payload_bits"] == payload
    assert emit.PACKED["field_bits"] - before["field_bits"] == 8


def test_writer_rejects_what_it_cannot_write():
    buf = np.zeros(12, np.uint8)
    ll, d = spec.fixed_tree_lengths()
    codes_ll, codes_d = np.zeros(288, np.uint32), np.zeros(32, np.uint32)
    with pytest.raises(ValueError, match="outside DEFLATE"):
        native.put_lz77(buf, 0, np.array([3]), np.array([40000]), codes_ll,
                        ll, codes_d, d)
    # The writer stores 8 bytes at a time, so it needs 8 spare bytes.
    with pytest.raises(ValueError, match="past the buffer"):
        native.put_lz77(buf, 0, np.zeros(8, np.int32), np.zeros(8, np.int32),
                        codes_ll, ll, codes_d, d)
    with pytest.raises(ValueError, match="past the buffer"):
        native.put_fields(buf, 40, np.array([1]), np.array([3]))
    buf[3] = 0b00010101
    assert native.put_fields(buf, 29, np.array([7]), np.array([3])) == 32
    assert buf[3] == 0b11110101
    assert not buf[4:].any()


@pytest.mark.parametrize("seed", range(4))
def test_native_tree_sizes_equal_encode_tree(seed):
    """add_dynamic_tree picks its variant by the native sizes: each of the
    8 must equal the Python encoder's, on real and random lengths."""
    tree_encode = importlib.import_module("zopfli_tpu_torch.tree_encode")
    rng = np.random.default_rng(seed)
    cases = [_lengths(_stores(k)[0], 2)
             for k in ("every_length", "every_distance", "one_literal")]
    for _ in range(60):
        ll = rng.integers(0, 16, 288) * (rng.random(288) < rng.random())
        d = rng.integers(0, 16, 32) * (rng.random(32) < rng.random())
        cases.append((ll, d))
    for ll, d in cases:
        want = [tree_encode.encode_tree(ll, d, bool(i & 1), bool(i & 2),
                                        bool(i & 4), None) for i in range(8)]
        assert native.tree_sizes(ll, d).tolist() == want


@pytest.mark.parametrize("maxbits", [7, 15])
def test_code_tables_equal_jax(maxbits):
    """Canonical codes and their bit reversal, vectorized in the port,
    equal the JAX package's loops on random code lengths."""
    jentropy = importlib.import_module("zopfli_tpu.entropy")
    entropy = importlib.import_module("zopfli_tpu_torch.entropy")
    rng = np.random.default_rng(maxbits)
    for n in (1, 19, 32, 288):
        for _ in range(30):
            lengths = rng.integers(0, maxbits + 1, n) * (rng.random(n) < 0.7)
            want = jentropy.lengths_to_symbols(lengths, maxbits)
            got = entropy.lengths_to_symbols(lengths, maxbits)
            assert got.dtype == want.dtype and (got == want).all()
            values = rng.integers(0, 1 << 16, n)
            assert (emit.reverse_bits(values, lengths)
                    == jemit.reverse_bits(values, lengths)).all()
            assert (emit.reverse_bits(want, lengths)
                    == jemit.reverse_bits(want, lengths)).all()
