import zlib

import pytest

from portbench.reference import containers

DATA = b"portbench reference " * 500 + bytes(range(256))


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 0x10]) + b[i + 1:]


def test_accepts_stock_zlib_and_gzip_streams():
    gz = zlib.compressobj(9, zlib.DEFLATED, 31)
    gz = gz.compress(DATA) + gz.flush()
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = raw.compress(DATA) + raw.flush()
    assert containers.check_gzip(gz, DATA)[1] is None
    assert containers.check_zlib(zlib.compress(DATA), DATA)[1] is None
    assert containers.check_deflate(raw, DATA)[1] is None


@pytest.mark.parametrize("where", ["header", "body", "crc", "isize"])
def test_rejects_a_flipped_bit_in_gzip(where):
    gz = zlib.compressobj(9, zlib.DEFLATED, 31)
    gz = gz.compress(DATA) + gz.flush()
    i = {"header": 2, "body": len(gz) // 2, "crc": len(gz) - 6,
         "isize": len(gz) - 2}[where]
    assert containers.check_gzip(_flip(gz, i), DATA)[1] is not None


def test_rejects_zlib_faults():
    z = zlib.compress(DATA)
    assert containers.check_zlib(_flip(z, len(z) - 1), DATA)[1]
    assert containers.check_zlib(z[:-1], DATA)[1]
    assert containers.check_zlib(z + b"\0", DATA)[1]
    assert containers.check_zlib(zlib.compress(DATA[:-1]), DATA)[1]
    assert containers.check_deflate(z[2:-4], DATA[1:])[1]


@pytest.mark.parametrize("fmt,wbits,frame", [("gzip", 31, 18),
                                             ("zlib", 15, 6),
                                             ("deflate", -15, 0)])
def test_zlib9_size_is_stdlib_level_9_in_the_container(fmt, wbits, frame):
    c = zlib.compressobj(9, zlib.DEFLATED, wbits)
    out = c.compress(DATA) + c.flush()
    assert containers.zlib9_size(fmt, DATA) == len(out)
    assert containers.CHECKS[fmt](out, DATA)[1] is None
    raw = zlib.compressobj(9, zlib.DEFLATED, -15)
    assert len(out) - frame == len(raw.compress(DATA) + raw.flush())
