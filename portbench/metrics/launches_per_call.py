"""Operations the device ran (kernels, copies, fills) per profiled
call, counted in the trace."""


def read(view):
    if not view.device:
        return None
    return len(view.device) / view.calls
