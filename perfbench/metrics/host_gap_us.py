"""Device-idle time inside the harness's span around each call, on the
fullest chip, averaged over the traced calls: the facade's host work,
dispatch, launch and the wait for the result."""


def read(r):
    t = r.trace
    if t is None or not t.devices:
        return None
    busy = t.per_call_busy_s(t.fullest())
    span = [(e - s) * 1e-9 for _, s, e in t.calls]
    return sum(a - b for a, b in zip(span, busy)) / len(span) * 1e6
