"""[zt.*_wait] spans per call: the host's blocking reads of device
results, its round trips to the device.  None without [zt.call]."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return sum(n.endswith("_wait") for n, _, _ in view.spans) / view.calls
