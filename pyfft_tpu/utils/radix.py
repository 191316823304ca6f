"""Radix / factorization math.

The analog of the reference's radix helpers (``pyfft/kernel_helpers.py``:
``log2``, ``getRadixArray``, ``getGlobalRadixInfo`` — see SURVEY.md §2.4).
``is_power_of_two`` validates every plan; the splitting helpers are the
factorisations the reference's kernel generator chose between.

All functions are pure and run at plan (trace) time only.
"""

from __future__ import annotations


def is_power_of_two(n: int) -> bool:
    """True iff ``n`` is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two."""
    if not is_power_of_two(n):
        raise ValueError(f"{n} is not a positive power of two")
    return n.bit_length() - 1


def balanced_split(n: int) -> tuple[int, int]:
    """Split power-of-two ``n`` into (n1, n2) with n1*n2 == n, n1 >= n2,
    as close to sqrt(n) as possible.

    Used by the four-step decomposition: both factors become DFT-matrix
    contraction sizes, so balanced factors keep both matmuls well shaped.
    """
    p = ilog2(n)
    p1 = (p + 1) // 2
    return 1 << p1, 1 << (p - p1)


def radix_decompose(n: int, max_radix: int) -> list[int]:
    """Greedy decomposition of power-of-two ``n`` into radices <= max_radix.

    Analog of the reference's ``getRadixArray(n, max_radix)``
    (SURVEY.md §2.4), re-derived: returns the largest-first list of
    power-of-two radices whose product is ``n``.
    """
    if not is_power_of_two(max_radix):
        raise ValueError("max_radix must be a power of two")
    p = ilog2(n)
    pr = ilog2(max_radix)
    radices = []
    while p > 0:
        r = min(p, pr)
        radices.append(1 << r)
        p -= r
    # Rebalance the tail: prefer e.g. [8, 4, 4] over [8, 8, 1]-style skew —
    # two mid-size stages instead of one large and one tiny.
    if len(radices) >= 2 and radices[-1] * 4 <= radices[-2]:
        total = radices[-1] * radices[-2]
        radices[-2], radices[-1] = balanced_split(total)
    return radices


def fourstep_split(n: int, max_base: int) -> tuple[int, int]:
    """Choose (n1, n2) for one four-step level of an n-point transform.

    Strategy: if ``n`` fits a single base-case DFT matmul the caller should
    not be splitting at all; otherwise peel factors so that the *second*
    (contiguous) factor is as large as possible without exceeding
    ``max_base``.
    """
    if n <= max_base:
        raise ValueError(f"n={n} fits the base case (max_base={max_base})")
    n2 = max_base
    n1 = n // n2
    return n1, n2
