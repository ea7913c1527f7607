"""Work done twice, per call: [zt.verify_fallback] spans (a block's
host re-squeeze after a failed verify) plus [zt.fetch_retry] spans (the
full path pull after a fetch-cap overflow).  None without [zt.call]."""

TWICE = ("zt.verify_fallback", "zt.fetch_retry")


def read(view):
    if not view.intervals("zt.call"):
        return None
    return sum(n in TWICE for n, _, _ in view.spans) / view.calls
