"""The entries a window drives, and how the reference judges each output.

A mix's `call` names the entry; the configuration's `options` are the
program's options as run, and its `format` picks the reference check:
- "compress": `zopfli_tpu_torch.compress(raw, format, Options(...))`,
  one call per item;
- "compress_many": `zopfli_tpu_torch.compress_many(raws, format,
  Options(...))`.
Each returns one output per item.

The check has two parts: the reference decodes every output (a wrong
one is bad), and holds its size below what the standard library's zlib at level 9 makes of the
same input in the same container (`containers.zlib9_size`): a Zopfli
output not smaller than that has given up what the encoder is for.
"""

from __future__ import annotations

import hashlib

from .reference import containers


def program_entry(call: str, config: dict):
    """run(items) -> outputs, through the port's public API."""
    import zopfli_tpu_torch as zt

    opts = dict(config.get("options", {}))
    fmt = config["format"]
    if call == "compress":
        o = zt.Options(**opts)
        return lambda items: [zt.compress(i.raw, fmt, o) for i in items]
    if call == "compress_many":
        o = zt.Options(**opts)
        return lambda items: zt.compress_many([i.raw for i in items], fmt, o)
    raise ValueError(f"unknown call {call!r}")


def judge(fmt: str, item, out) -> str | None:
    """None where `out` is a correct output for `item`, else why not."""
    if not isinstance(out, (bytes, bytearray)):
        return f"output is {type(out).__name__}, not bytes"
    return containers.CHECKS[fmt](bytes(out), item.expect)[1]


class Checker:
    """Judges outputs, each distinct (input, output) pair once: a pool
    cycles, and a deterministic program gives the same bytes again.
    `not_smaller` counts outputs at least as large as zlib level 9's;
    `worst_ratio` is the largest output size over zlib level 9's seen."""

    def __init__(self, fmt: str):
        self.fmt = fmt
        self.seen: dict = {}
        self.bad = 0
        self.checked = 0
        self.reasons: dict = {}
        self.zlib9: dict = {}
        self.not_smaller = 0
        self.worst_ratio = 0.0

    def __call__(self, item, out) -> None:
        digest = hashlib.sha1(out).digest() \
            if isinstance(out, (bytes, bytearray)) else None
        key = (item.key, digest)
        if key not in self.seen:
            self.seen[key] = judge(self.fmt, item, out)
        why = self.seen[key]
        self.checked += 1
        if why:
            self.bad += 1
            self.reasons[why] = self.reasons.get(why, 0) + 1
        if digest is not None:
            if item.key not in self.zlib9:
                self.zlib9[item.key] = containers.zlib9_size(self.fmt,
                                                             item.raw)
            ratio = len(out) / self.zlib9[item.key]
            self.worst_ratio = max(self.worst_ratio, ratio)
            self.not_smaller += ratio >= 1.0
