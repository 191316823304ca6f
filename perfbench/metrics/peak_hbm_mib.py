"""The allocator's ``peak_bytes_in_use`` on the fullest chip, read right
after the window, before the check allocates anything."""


def read(r):
    if r.memory_peak_bytes is None:
        return None
    return r.memory_peak_bytes / 2 ** 20
