"""gzip (RFC 1952): header, DEFLATE stream, CRC-32 and ISIZE, checked by
`containers.check_gzip` against the input; the yardstick is the
standard library's zlib at level 9 on the same input in the same
container."""

from portbench.reference import containers


def judge(out: bytes, item) -> str | None:
    return containers.check_gzip(out, item.expect)[1]


def zlib9_size(item) -> int:
    return containers.zlib9_size("gzip", item.raw)
