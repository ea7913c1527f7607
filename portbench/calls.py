"""The entries a window drives, and how the reference judges each output.

A mix's `call` names the entry, `entries/<call>.py`, whose
`entry(config)` gives `run(items) -> outputs`, one output per item; the
configuration's `options` are the program's options as run.  Its
`format` names the reference check, `reference/formats/<format>.py`.

The check has two parts: the format's `judge` decodes every output (a
wrong one is bad), and the output's size is held below the format's
`zlib9_size`, what the standard library's zlib at level 9 makes of the
same input in the same format: a Zopfli output not smaller than that
has given up what the encoder is for.
"""

from __future__ import annotations

import hashlib

from .manifest import Manifest


def program_entry(call: str, config: dict, man: Manifest | None = None):
    """run(items) -> outputs, through the port's public API: the entry
    `call` found under `man`'s bench dir (the benchmark's own by
    default)."""
    return (man or Manifest()).module("entries", call).entry(config)


def judge(fmt, item, out) -> str | None:
    """None where `out` is a correct output for `item` in the format
    module `fmt`, else why not."""
    if not isinstance(out, (bytes, bytearray)):
        return f"output is {type(out).__name__}, not bytes"
    return fmt.judge(bytes(out), item)


class Checker:
    """Judges outputs by the format module `fmt`, each distinct (input,
    output) pair once: a pool cycles, and a deterministic program gives
    the same bytes again.  `not_smaller` counts outputs at least as
    large as zlib level 9's; `worst_ratio` is the largest output size
    over zlib level 9's seen."""

    def __init__(self, fmt):
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
                self.zlib9[item.key] = self.fmt.zlib9_size(item)
            ratio = len(out) / self.zlib9[item.key]
            self.worst_ratio = max(self.worst_ratio, ratio)
            self.not_smaller += ratio >= 1.0
