"""The port's diagnostic counters, safe to bump from several host threads.

The counters themselves stay plain module-level dicts and one-element
lists (scan_kernel.LAUNCHES, devsplit.STATS, seed.PROGRAMS,
engine.FALLBACKS, fused_engine.FETCH_RETRIES, fused_engine.VERIFY,
fused_engine.RANDOM, squeeze_batched.VERIFY_FAILS, emit.PACKED,
png.optimize.PROBE), so their readers index them as before.
fused_engine.VERIFY counts the blocks whose parse the native pass
checked ("blocks") and the matched bytes it compared ("match_bytes").
fused_engine.RANDOM keeps the most randomization events a block row of
the fused loop drew ("events_max", a maximum, not a sum) and counts the
uploads of the loop's randomization maps ("maps_built").
emit.PACKED counts the bits that each BitStream pack wrote with the
native payload pass ("payload_bits") and as header and tree fields
("field_bits").
`counter[key] += n` is a read-modify-write that the interpreter lock does
not make atomic: masters on worker threads (deflate.deflate with
Options.workers != 1), and the PNG probe's trials on its thread pool,
bump the same counter at once, and every bump goes through one lock
here.

The work done twice that FETCH_RETRIES and VERIFY_FAILS count also runs
under spans of its own, [zt.fetch_retry] and [zt.verify_fallback]
(utils.logging.span), which the benchmark's `retries_per_call` counts
per call in a traced run.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()


def bump(counter, key=0, n: int = 1) -> None:
    """counter[key] += n under the counters' lock."""
    with _lock:
        counter[key] += n


def bump_max(counter, key, n: int) -> None:
    """counter[key] = max(counter[key], n) under the counters' lock."""
    with _lock:
        counter[key] = max(counter[key], n)
