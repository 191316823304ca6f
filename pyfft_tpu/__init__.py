"""pyfft_tpu — batched power-of-two complex FFT framework in JAX.

A from-scratch JAX rebuild of the capabilities of fjarri-attic/pyfft (see
SURVEY.md): batched 1D/2D/3D complex transforms, forward/inverse,
single/double precision, interleaved and split complex storage, behind the
same ``Plan(shape).execute(data)`` surface.  Every transform is one XLA FFT
op, which XLA lowers to cuFFT on an NVIDIA GPU.
"""

VERSION = (0, 6, 0)
__version__ = ".".join(map(str, VERSION))

from pyfft_tpu.plan import Plan
from pyfft_tpu.api import (fft, ifft, fft2, ifft2, fftn, ifftn,
                           fftshift, ifftshift, fftfreq)
from pyfft_tpu.utils.cache import enable_compile_cache, warmup
from pyfft_tpu.real import (rfft, irfft, rfft2, irfft2, rfftn, irfftn,
                            rfft_planar, irfft_planar, rfftn_planar,
                            irfftn_planar)

__all__ = ["Plan", "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "rfft_planar", "irfft_planar", "rfftn_planar", "irfftn_planar",
           "fftshift", "ifftshift", "fftfreq",
           "enable_compile_cache", "warmup",
           "VERSION", "__version__"]
