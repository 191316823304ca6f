"""Device time of the NCCL kernels (the all_to_all exchanges) per traced
call, on the fullest chip.  None where no NCCL kernel ran."""


def read(r):
    t = r.trace
    if t is None or not t.devices:
        return None
    seconds = t.op_seconds(t.fullest(), lambda n: "nccl" in n.lower())
    if seconds == 0.0:
        return None
    return seconds / len(t.calls) * 1e6
