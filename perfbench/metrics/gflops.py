"""5·N·log2(N)·batch summed over every call the window completed, over the
window's seconds on the host clock."""


def read(r):
    if not r.call_s:
        return None
    return r.flops_per_call * len(r.call_s) / r.window_s / 1e9
