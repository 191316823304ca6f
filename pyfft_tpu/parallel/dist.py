"""Distributed FFT over a JAX device mesh.

The reference is strictly single-device (SURVEY.md §2: "no NCCL/MPI/Gloo/UCX
anywhere"); this module is the *extension* the survey names as the natural
stretch goal: the four-step decomposition's transpose step becomes
`all_to_all` over the mesh, so one transform can span devices, and batch
parallelism is plain sharding over the data axis.  On NVIDIA GPUs XLA hands
each `all_to_all` to NCCL; nothing touches the host.

Mesh contract (mesh axis names are parameters):
  * ``dp`` — batch parallelism: transforms are independent, no communication.
  * ``sp`` — sequence parallelism: the transform axis is sharded; a length-N
    FFT on S devices runs as

      1. all_to_all      j-chunks -> all outer digits j1 for a j2-slice
      2. local S-point DFT over j1 (the cross-device factor)   [einsum]
      3. twiddle w_N^(j1_out * j2_global)
      4. all_to_all      -> full j2 range for this device's k1
      5. local length-L FFT over j2 (the heavy factor — one XLA FFT op,
         as in single-device plans)
      6. all_to_all      strided spectral index -> contiguous shards

Inputs and outputs are planar (re, im) arrays; inside the shard_map body each
shard is one complex array, so every exchange is a single `all_to_all` and
every local FFT is one XLA FFT op (cuFFT on a GPU).  complex128 runs through
the same code on float64 planes (``jax_enable_x64``).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyfft_tpu.ops.twiddle import dft_matrix
from pyfft_tpu.utils.radix import is_power_of_two

__all__ = ["dist_fft_1d", "make_dist_fft", "make_dist_fft2",
           "make_dist_fft3"]


def _a2a(x, seq_axis: str, split: int, concat: int):
    # all_to_all rejects negative axis indices — normalize.
    return jax.lax.all_to_all(x, seq_axis, split_axis=split % x.ndim,
                              concat_axis=concat % x.ndim, tiled=True)


def _local_fft(x, sign: int, axes: tuple[int, ...]):
    """Local FFT of a complex shard over ``axes``: forward for sign=-1, and
    for sign=+1 numpy's inverse, which divides by the product of the axis
    lengths (the callers fold that into their one final multiply)."""
    if sign < 0:
        return jnp.fft.fftn(x, axes=axes)
    return jnp.fft.ifftn(x, axes=axes)


def _finish(x, scale: float):
    if scale != 1.0:
        x = x * scale
    return jnp.real(x), jnp.imag(x)


def _dist_fft_body(re, im, *, sign: int, n: int, s: int, seq_axis: str,
                   scale: float):
    """shard_map body: local blocks (..., L) with L = n // s."""
    L = n // s
    rdt = re.dtype
    me = jax.lax.axis_index(seq_axis)
    x = jax.lax.complex(re, im)
    lead = x.shape[:-1]

    # Step 1: gather every outer digit j1 for a slice of j2.
    # all_to_all(tiled): split j2 (last axis) into S chunks, exchange, and
    # stack the received j1 digits on a new axis -2.
    x = _a2a(x[..., None, :], seq_axis, -1, -2)   # (..., S(j1), L/S(j2))

    # Step 2: S-point DFT over j1 (cross-device factor) — a small
    # contraction.  HIGHEST keeps a float32 product out of TF32 on a GPU.
    wr, wi = dft_matrix(s, sign, np.float64)
    w = jnp.asarray(wr + 1j * wi, x.dtype)
    x = jnp.einsum("kj,...jl->...kl", w, x,
                   precision=jax.lax.Precision.HIGHEST)

    # Step 3: twiddle w_N^(k1 * j2_global); j2_global = me*(L/S) + local.
    # The phase index is reduced mod n in integers BEFORE the float cast:
    # k1*j2 < n always, but reducing keeps the float32 angle error bounded
    # by 2^-24 of a full turn for every n (an unreduced f32 product loses
    # integer exactness beyond 2^24 — the tables of ops/twiddle.py are
    # exact for the same reason).
    k1 = jax.lax.broadcasted_iota(jnp.int32, (s, L // s), 0)
    j2 = jax.lax.broadcasted_iota(jnp.int32, (s, L // s), 1) + me * (L // s)
    m = (k1 * j2) % np.int32(n) if n < 2 ** 31 else (
        (k1.astype(jnp.int64) * j2.astype(jnp.int64)) % n)
    ang = m.astype(rdt) * rdt.type((-2.0 if sign < 0 else 2.0) * math.pi / n)
    x = x * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))

    # Step 4: full j2 range for this device's k1 digit.
    x = _a2a(x, seq_axis, -2, -1).reshape(*lead, L)

    # Step 5: the heavy local factor.
    x = _local_fft(x, sign, (-1,))                # (..., L) over k2

    # Step 6: strided k = k2*S + k1(=me) -> contiguous shards, then the
    # local interleave out_local[m*S + u] = g[u, m].
    x = _a2a(x.reshape(*lead, s, L // s), seq_axis, -2, -1)
    x = jnp.swapaxes(x.reshape(*lead, s, L // s), -1, -2).reshape(*lead, L)
    return _finish(x, scale)


def _shard_mapped(body, mesh: Mesh, spec):
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec)))


def make_dist_fft(mesh: Mesh, n: int, *, batch_axis: str = "dp",
                  seq_axis: str = "sp", sign: int = -1,
                  normalize: bool = False):
    """Build a jitted distributed 1D FFT over ``mesh``.

    Input/output: planar (re, im) arrays of shape (B, n), batch sharded over
    ``batch_axis`` and the transform axis sharded over ``seq_axis``;
    float32 planes for complex64, float64 planes for complex128.
    """
    if not is_power_of_two(n):
        raise ValueError(f"n={n} is not a power of two")
    s = mesh.shape[seq_axis]
    if n % (s * s) != 0:
        raise ValueError(f"n={n} must be divisible by seq_parallel^2={s*s}")
    # the local inverse FFT divides by L = n / s; the cross-device DFT
    # divides by nothing
    scale = 1.0
    if sign > 0:
        scale = (1.0 / s) if normalize else float(n // s)
    body = functools.partial(_dist_fft_body, sign=sign, n=n, s=s,
                             seq_axis=seq_axis, scale=scale)
    return _shard_mapped(body, mesh, P(batch_axis, seq_axis))


def _dist_fft2_body(re, im, *, sign: int, seq_axis: str, scale: float):
    """shard_map body for 2D: local blocks (..., ny/S, nx).

    1. FFT over nx (fully local rows)
    2. all_to_all: nx becomes sharded, ny becomes local (the transpose)
    3. FFT over ny (now a fully local column pass)
    4. all_to_all back to the input layout
    """
    x = _local_fft(jax.lax.complex(re, im), sign, (-1,))
    x = _a2a(x, seq_axis, -1, -2)                 # (..., ny, nx/S)
    x = _local_fft(x, sign, (-2,))
    x = _a2a(x, seq_axis, -2, -1)                 # (..., ny/S, nx)
    return _finish(x, scale)


def make_dist_fft2(mesh: Mesh, shape: tuple[int, int], *,
                   batch_axis: str = "dp", seq_axis: str = "sp",
                   sign: int = -1, normalize: bool = False):
    """Build a jitted distributed 2D FFT over ``mesh``.

    Input/output: planar (re, im) arrays of shape (B, ny, nx), batch sharded
    over ``batch_axis`` and the ny axis sharded over ``seq_axis``.  The
    row pass runs fully local, the inter-axis transpose is one
    ``all_to_all`` each way, and the column pass runs local — the
    multi-device analog of the single-device 2D transform.
    """
    ny, nx = shape
    if not (is_power_of_two(ny) and is_power_of_two(nx)):
        raise ValueError(f"shape {shape} must be powers of two")
    s = mesh.shape[seq_axis]
    if ny % s or nx % s:
        raise ValueError(f"both axes of {shape} must be divisible by "
                         f"seq parallelism {s}")
    # the local inverse FFTs already divide by ny * nx
    scale = float(ny * nx) if (sign > 0 and not normalize) else 1.0
    body = functools.partial(_dist_fft2_body, sign=sign, seq_axis=seq_axis,
                             scale=scale)
    return _shard_mapped(body, mesh, P(batch_axis, seq_axis, None))


def _dist_fft3_body(re, im, *, sign: int, seq_axis: str, scale: float):
    """shard_map body for 3D: local blocks (..., nz/S, ny, nx).

    1. local 2D FFT over (ny, nx) per z-slice, one FFT op
    2. all_to_all: nx becomes sharded, nz local (the transpose)
    3. local FFT over nz
    4. all_to_all back to the input layout
    """
    x = _local_fft(jax.lax.complex(re, im), sign, (-2, -1))
    x = _a2a(x, seq_axis, -1, -3)                 # (..., nz, ny, nx/S)
    x = _local_fft(x, sign, (-3,))
    x = _a2a(x, seq_axis, -3, -1)                 # (..., nz/S, ny, nx)
    return _finish(x, scale)


def make_dist_fft3(mesh: Mesh, shape: tuple[int, int, int], *,
                   batch_axis: str = "dp", seq_axis: str = "sp",
                   sign: int = -1, normalize: bool = False):
    """Build a jitted distributed 3D FFT over ``mesh``.

    Input/output: planar (re, im) arrays of shape (B, nz, ny, nx), batch
    sharded over ``batch_axis`` and the nz axis over ``seq_axis``.  The
    (ny, nx) planes transform fully locally per z-slice; one ``all_to_all``
    each way moves the z axis on/off the device boundary for its column
    pass.
    """
    nz, ny, nx = shape
    for d in shape:
        if not is_power_of_two(d):
            raise ValueError(f"shape {shape} must be powers of two")
    s = mesh.shape[seq_axis]
    if nz % s or nx % s:
        raise ValueError(f"nz and nx of {shape} must be divisible by "
                         f"seq parallelism {s}")
    # the local inverse FFTs already divide by nz * ny * nx
    scale = float(math.prod(shape)) if (sign > 0 and not normalize) else 1.0
    body = functools.partial(_dist_fft3_body, sign=sign, seq_axis=seq_axis,
                             scale=scale)
    return _shard_mapped(body, mesh, P(batch_axis, seq_axis, None, None))


def dist_fft_1d(re, im, mesh: Mesh, *, sign: int = -1,
                batch_axis: str = "dp", seq_axis: str = "sp",
                normalize: bool = False):
    """One-shot distributed FFT of planar (B, N) arrays over ``mesh``."""
    n = re.shape[-1]
    fn = make_dist_fft(mesh, n, batch_axis=batch_axis, seq_axis=seq_axis,
                       sign=sign, normalize=normalize)
    spec = NamedSharding(mesh, P(batch_axis, seq_axis))
    re = jax.device_put(re, spec)
    im = jax.device_put(im, spec)
    return fn(re, im)
