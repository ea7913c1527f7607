"""The port's diagnostic counters, safe to bump from several host threads.

The counters themselves stay plain module-level dicts and one-element
lists (scan_kernel.LAUNCHES, devsplit.STATS, seed.PROGRAMS,
engine.FALLBACKS, fused_engine.FETCH_RETRIES,
squeeze_batched.VERIFY_FAILS), so their readers index them as before.
`counter[key] += n` is a read-modify-write that the interpreter lock does
not make atomic: masters on worker threads (deflate.deflate with
Options.workers != 1) bump the same counter at once, and every bump goes
through one lock here.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()


def bump(counter, key=0, n: int = 1) -> None:
    """counter[key] += n under the counters' lock."""
    with _lock:
        counter[key] += n
