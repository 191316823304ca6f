"""The work a transform call must do, from its shapes alone, and the peaks
of the chip it runs on.

Operations follow upstream pyfft's metric (its ``test/test_performance.py``):
5·N·log2(N) per transform of N points, times the batch.  Bytes are one read
and one write of the complex data, the least any implementation moves:
split planes and interleaved complex hold the same bytes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def flops(shape, batch: int) -> float:
    """5·N·log2(N)·batch for a transform of ``shape`` (N = its points)."""
    n = math.prod(shape)
    return 5.0 * n * math.log2(n) * batch


def io_bytes(shape, batch: int, dtype) -> int:
    """One read and one write of the complex data."""
    return 2 * math.prod(shape) * batch * np.dtype(dtype).itemsize


def peaks(device_kind: str) -> dict:
    """The data-sheet peaks of ``device_kind``; a device not in the table
    is an error, never a default."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if device_kind not in table:
        raise KeyError(f"no peaks for device kind {device_kind!r} in "
                       f"{PEAKS_FILE.name}; add them with their source")
    return table[device_kind]


def least_seconds(shape, batch: int, dtype, chips: int, peak: dict) -> float:
    """The least time one chip could take for its share of a call: the
    larger of its bytes over peak bandwidth and its operations over the
    vector peak of the data's precision."""
    fp = "fp64_flops_per_s" if np.dtype(dtype) == np.complex128 \
        else "fp32_flops_per_s"
    return max(io_bytes(shape, batch, dtype) / chips / peak["hbm_bytes_per_s"],
               flops(shape, batch) / chips / peak[fp])
