"""The one generator of every traffic mix: a mix's JSON file in, a pool
of calls out, the same pool for the same seed.

A mix file holds:
- `inputs`: the input kind, `inputs/<kind>.py`, whose
  `items(mix, seed)` makes the pool's items from the mix's parameters;
- `call`: the entry each call of the window drives (`entries/<call>.py`);
- `per_call`: items a call hands to that entry;
- `trace_calls`: the most calls a traced run profiles;
- `passes`: how many passes of the mix the pool holds; a kind deals
  each pass the same inputs, in an order the seed draws, so every seed
  sends the same work.

The window cycles the pool and closes at the end of a pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .manifest import Manifest


@dataclass
class Item:
    """One input a call hands to the program.  `raw` is what the user
    hands over; `expect` what the reference holds the output to (for
    text the same bytes, for an image its pixels); `nbytes` the input
    bytes counted in the rate (for text `len(raw)`, for an image its
    pixel bytes)."""
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


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *stream])


def make_pool(mix: dict, seed: int, man: Manifest | None = None) -> Pool:
    """The mix's items from its input kind, found under `man`'s bench dir
    (the benchmark's own by default), in calls of `per_call`."""
    per_call, passes = int(mix["per_call"]), int(mix["passes"])
    kind = (man or Manifest()).module("inputs", mix["inputs"])
    items = kind.items(mix, seed)
    per_pass = len(items) // passes
    if per_pass * passes != len(items) or per_pass % per_call:
        raise ValueError(f"{len(items)} items in {passes} passes do not "
                         f"fill calls of {per_call}")
    calls = [items[i:i + per_call] for i in range(0, len(items), per_call)]
    return Pool(calls, per_pass // per_call)
