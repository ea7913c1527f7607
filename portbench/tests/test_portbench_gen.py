import zlib

import pytest

from portbench import gen
from portbench.manifest import Manifest

text = Manifest().module("inputs", "text")

MIXES = ("canterbury-large", "canterbury", "calgary-batch")


def test_corpus_matches_its_manifest():
    blob, files = text.load_corpus()
    assert len(blob) == 426825
    assert zlib.crc32(blob) == 283473244
    assert len(files) == 47 and files[-1][2] == len(blob)


@pytest.mark.parametrize("mix", MIXES)
def test_pool_is_a_function_of_the_seed(mix):
    m = Manifest().traffic(mix)
    seed = 2 ** 31 + 12345
    a, b = gen.make_pool(m, seed), gen.make_pool(m, seed)
    c = gen.make_pool(m, seed + 1)
    flat = lambda p: [i.raw for i in p.items()]  # noqa: E731
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)
    assert len(a.items()) == m["passes"] * len(m["sizes"])
    assert all(len(call) == m["per_call"] for call in a.calls)
    assert a.cycle * m["per_call"] == len(m["sizes"])


@pytest.mark.parametrize("mix", MIXES)
def test_every_pass_deals_each_size_once(mix):
    m = Manifest().traffic(mix)
    for seed in (1, 2 ** 33):
        pool = gen.make_pool(m, seed)
        n = len(m["sizes"])
        items = pool.items()
        for p in range(m["passes"]):
            assert sorted(i.nbytes for i in items[p * n:(p + 1) * n]) \
                == sorted(m["sizes"])


def test_items_are_consecutive_cuts_of_the_corpus():
    blob, _ = text.load_corpus()
    items = text.text_items(blob, [5000, 3 * len(blob), 7], 1, 5)
    joined = b"".join(i.raw for i in items)
    start = (blob * 2).find(joined[:4096])
    assert start >= 0
    rep = blob[start:] + blob * (len(joined) // len(blob) + 1)
    assert joined == rep[:len(joined)]


def test_text_repeats_lie_past_the_window():
    blob, _ = text.load_corpus()
    item = text.text_items(blob, [3 * len(blob)], 1, 5)[0]
    n = len(blob)
    assert item.raw[:n] == item.raw[n:2 * n]
    assert n > 32768                # farther back than the window
