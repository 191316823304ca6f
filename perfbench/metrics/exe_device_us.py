"""The union of device-op intervals inside each call's span, on the
fullest chip, averaged over the traced calls: the jitted executable's
device time (conversions, FFT kernels, scaling, exchanges)."""


def read(r):
    t = r.trace
    if t is None or not t.devices:
        return None
    busy = t.per_call_busy_s(t.fullest())
    if not any(busy):
        return None
    return sum(busy) / len(busy) * 1e6
