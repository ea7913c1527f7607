"""raw DEFLATE (RFC 1951): one stream, nothing after its final block, checked by
`containers.check_deflate` against the input; the yardstick is the
standard library's zlib at level 9 on the same input in the same
container."""

from portbench.reference import containers


def judge(out: bytes, item) -> str | None:
    return containers.check_deflate(out, item.expect)[1]


def zlib9_size(item) -> int:
    return containers.zlib9_size("deflate", item.raw)
