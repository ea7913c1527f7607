"""Text: cuts of the frozen corpus in `data/`.

The mix's `sizes` is a list of input sizes in bytes, one pass of the
mix.  Each pass deals every size once, in an order the seed draws, so
every seed sends the same sizes.  The items are consecutive cuts of the
corpus repeated in its recorded order, from an offset the seed draws:
the pool's content is the same corpus for every seed, cut in other
places.  An item's `expect` is its `raw`, and `nbytes` its length.
"""

from __future__ import annotations

import json
import os
import zlib

from portbench.gen import Item, rng_for

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def load_corpus() -> tuple[bytes, list]:
    """The frozen text corpus and its files' [path, start, end], checked
    against the recorded length and CRC-32: a corpus that changed would
    change every text cell."""
    with open(os.path.join(DATA, "corpus.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DATA, meta["file"]), "rb") as f:
        blob = f.read()
    if len(blob) != meta["bytes"] or zlib.crc32(blob) != meta["crc32"]:
        raise RuntimeError(
            f"corpus changed: {len(blob)} B, CRC-32 {zlib.crc32(blob)}; "
            f"recorded {meta['bytes']} B, {meta['crc32']}")
    return blob, meta["files"]


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


def items(mix: dict, seed: int) -> list:
    return text_items(load_corpus()[0], [int(n) for n in mix["sizes"]],
                      int(mix["passes"]), seed)
