"""The share of the traced window in which no op ran on the device,
averaged over the chips, in percent."""


def read(r):
    t = r.trace
    if t is None or not t.devices:
        return None
    return 100.0 * (1.0 - t.mean_busy_s() / t.window_s)
