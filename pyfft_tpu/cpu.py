"""``from pyfft_tpu.cpu import Plan`` — the same ``Plan`` as the package's.

Parity shim with the reference's second backend module (``pyfft/cl.py``,
SURVEY.md §2.7).  There is one executor, XLA's FFT op, and it runs on every
JAX backend, so this module only re-exports ``pyfft_tpu.plan.Plan``.
"""

from pyfft_tpu.plan import Plan

__all__ = ["Plan"]
