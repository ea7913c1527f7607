"""The pools of the three text cells, frozen: for seeds 0-3 each mix's
pool is byte for byte what it was when the input kinds moved into
`inputs/`, in the same calls.  A pool that changes changes what every
later check compares against the ledger."""

import hashlib

import pytest

from portbench import gen
from portbench.manifest import Manifest

# mix: (calls in the pool, calls in one pass, [sha-256 over each item's
# key, raw, nbytes and expect, in call order, for seeds 0, 1, 2, 3])
FROZEN = {
    "canterbury-large": (6, 3, [
        "18491de10c9b7277f52bb33dc177050dd0f8378dfd7a116e11f5a206ded8a1fa",
        "a483d7e1d70f54677ae2d7716679efa1b17ea1e1c9353b1e3fd58f221643eecb",
        "e1ec521df655961fdbf18a917b22acfc339b3182527f28f80fb1af0f4a2e6de3",
        "24cdbd43531a83c06000aa9eb912deff2f3f8965fd00be1bde280766944ec4fd",]),
    "canterbury": (22, 11, [
        "d4bf634a4a59ed7bfa4f18f04381db56b2c85c9ca897c10c28ccda405b0e7d22",
        "269a421f905cf0badf0c64cb6bf36de7456a6deaf25d890ca9030bc9b53b30c0",
        "d2f42d7cf1844bee9a6ccc11899592841d597f99cd1c575de4879f00fc79b4a2",
        "fd207631c64ac1f721b2d77271251796275bd4821eedb8ac18328a77601b8002",]),
    "calgary-batch": (2, 1, [
        "f83065f66594c50d18a8f532af2eafbe3462e131db772fd929fffecaada85421",
        "a2cb5a6dfb80d1e70ddcc57cea66f44fb4b66364b37a609ad17cd934f1e32c7c",
        "f3b41f00ecd6ac6751f1deb162bf5bc7fb9b06ec9dd76a5daa75ebb443706112",
        "644de9f437649cb76fd10755053a8d225e32acdaec7b1cc86a492e69b68ef63d",]),
}


def pool_digest(pool) -> str:
    h = hashlib.sha256()
    for item in pool.items():
        for part in (item.key.encode(), item.raw,
                     str(item.nbytes).encode(), item.expect):
            h.update(len(part).to_bytes(8, "little"))
            h.update(part)
    return h.hexdigest()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mix", sorted(FROZEN))
def test_pool_is_frozen(mix, seed):
    man = Manifest()
    pool = gen.make_pool(man.traffic(mix), seed, man)
    ncalls, cycle, digests = FROZEN[mix]
    assert (len(pool.calls), pool.cycle) == (ncalls, cycle)
    assert pool_digest(pool) == digests[seed]
