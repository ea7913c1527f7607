"""Share of the traced window's wall in which no kernel, copy or fill ran
on the device: the union of the device's intervals, not the sum of
their times, so overlapping work counts once."""


def read(view):
    if not view.device or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
