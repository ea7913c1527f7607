"""zlib (RFC 1950): header, DEFLATE stream and Adler-32, checked by
`containers.check_zlib` against the input; the yardstick is the
standard library's zlib at level 9 on the same input in the same
container."""

from portbench.reference import containers


def judge(out: bytes, item) -> str | None:
    return containers.check_zlib(out, item.expect)[1]


def zlib9_size(item) -> int:
    return containers.zlib9_size("zlib", item.raw)
