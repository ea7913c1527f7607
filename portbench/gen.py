"""The one generator of every traffic mix: a mix's JSON file in, a pool
of calls out, the same pool for the same seed.

A mix file holds:
- `inputs`: "text", cuts of the frozen corpus in `data/`;
- `call`: the entry each call of the window drives (`calls.py`);
- `per_call`: items a call hands to that entry;
- `trace_calls`: the most calls a traced run profiles;
- `sizes`: a list of input sizes in bytes, one pass of the mix, and
  `passes`: how many passes the pool holds.  Each pass deals
  every size once, in an order the seed draws, so every seed sends the
  same sizes.  The items are consecutive cuts of the corpus repeated in
  its recorded order, from an offset the seed draws: the pool's content
  is the same corpus for every seed, cut in other places.

The window cycles the pool and closes at the end of a pass.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Item:
    """One input a call hands to the program.  `raw` is what the user
    compresses; `expect` what the reference holds the output to;
    `nbytes` the input bytes counted in the rate."""
    key: str
    raw: bytes
    nbytes: int
    expect: object = None


@dataclass
class Pool:
    calls: list = field(default_factory=list)   # list of lists of Item
    cycle: int = 1                              # calls in one pass

    def items(self) -> list:
        """The pool's distinct items, in call order."""
        return [i for call in self.calls for i in call]


def load_corpus() -> tuple[bytes, list]:
    """The frozen text corpus and its files' [path, start, end], checked
    against the recorded length and CRC-32: a corpus that changed would
    change every text cell."""
    with open(os.path.join(HERE, "data", "corpus.json")) as f:
        meta = json.load(f)
    with open(os.path.join(HERE, "data", meta["file"]), "rb") as f:
        blob = f.read()
    if len(blob) != meta["bytes"] or zlib.crc32(blob) != meta["crc32"]:
        raise RuntimeError(
            f"corpus changed: {len(blob)} B, CRC-32 {zlib.crc32(blob)}; "
            f"recorded {meta['bytes']} B, {meta['crc32']}")
    return blob, meta["files"]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *stream])


def text_items(corpus: bytes, sizes: list, passes: int, seed: int):
    """`passes` passes of `sizes`, each dealt in an order the seed draws,
    cut one after another from the corpus repeated, from an offset the
    seed draws.  A repeat lies len(corpus) bytes back, farther than
    DEFLATE's window."""
    rng = rng_for(seed, 0)
    deal = [sizes[j] for _ in range(passes)
            for j in rng.permutation(len(sizes))]
    off = int(rng.integers(0, len(corpus)))
    stream = corpus * ((off + sum(deal)) // len(corpus) + 1)
    items = []
    for k, size in enumerate(deal):
        raw = stream[off:off + size]
        items.append(Item(f"t{k}", raw, len(raw), raw))
        off += size
    return items


def make_pool(mix: dict, seed: int) -> Pool:
    if mix["inputs"] != "text":
        raise ValueError(f"unknown inputs {mix['inputs']!r}")
    per_call = int(mix["per_call"])
    sizes = [int(n) for n in mix["sizes"]]
    if len(sizes) % per_call:
        raise ValueError(f"{len(sizes)} sizes a pass do not fill calls of "
                         f"{per_call}")
    items = text_items(load_corpus()[0], sizes, int(mix["passes"]), seed)
    calls = [items[i:i + per_call] for i in range(0, len(items), per_call)]
    return Pool(calls, len(sizes) // per_call)
