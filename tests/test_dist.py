"""Distributed FFT over the 8-virtual-device CPU mesh (conftest forces it).

Validates the shard_map four-step: batch sharding over 'dp', transform-axis
sharding over 'sp' with all_to_all exchanges, vs numpy.fft; and that no
contraction in the shard_map bodies may run below float32 precision (a
float32 dot without HIGHEST may run in TF32 on a GPU).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from jax.sharding import NamedSharding, PartitionSpec as P

from pyfft_tpu.parallel import (dist_fft_1d, make_dist_fft, make_dist_fft2,
                                make_dist_fft3)

from helpers import TOL, rand_complex, rel_err


def _mesh(dp, sp):
    devs = np.array(jax.devices()[: dp * sp]).reshape(dp, sp)
    return Mesh(devs, ("dp", "sp"))


@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_dist_fft_parity(dp, sp):
    mesh = _mesh(dp, sp)
    n, b = 512, 8
    x = rand_complex((b, n), seed=dp * 10 + sp)
    re, im = dist_fft_1d(np.real(x).copy(), np.imag(x).copy(), mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(got, ref) < TOL[np.complex64]


def test_dist_fft_roundtrip():
    mesh = _mesh(2, 4)
    n, b = 1024, 4
    x = rand_complex((b, n), seed=3)
    fr, fi = dist_fft_1d(np.real(x).copy(), np.imag(x).copy(), mesh, sign=-1)
    br, bi = dist_fft_1d(np.asarray(fr), np.asarray(fi), mesh, sign=+1,
                         normalize=True)
    got = np.asarray(br) + 1j * np.asarray(bi)
    assert rel_err(got, x) < TOL[np.complex64]


def test_make_dist_fft_validates():
    mesh = _mesh(1, 8)
    with pytest.raises(ValueError):
        make_dist_fft(mesh, 24)
    with pytest.raises(ValueError):
        make_dist_fft(mesh, 32)  # 32 < 8*8


def test_dist_fft2_parity():
    """Distributed 2D: rows local, all_to_all transpose, columns local."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from pyfft_tpu.parallel.dist import make_dist_fft2

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs).reshape(2, 4), ("dp", "sp"))
    ny, nx = 64, 128
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((4, ny, nx))
         + 1j * rng.standard_normal((4, ny, nx))).astype(np.complex64)
    fwd = make_dist_fft2(mesh, (ny, nx))
    inv = make_dist_fft2(mesh, (ny, nx), sign=+1, normalize=True)
    spec = NamedSharding(mesh, P("dp", "sp", None))
    re = jax.device_put(x.real.astype(np.float32), spec)
    im = jax.device_put(x.imag.astype(np.float32), spec)
    rr, ii = fwd(re, im)
    got = np.asarray(rr) + 1j * np.asarray(ii)
    ref = np.fft.fftn(x.astype(np.complex128), axes=(1, 2))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6
    br, bi = inv(rr, ii)
    rt = np.asarray(br) + 1j * np.asarray(bi)
    assert np.abs(rt - x).max() / np.abs(x).max() < 2e-6


def test_dist_fft3_parity():
    """Distributed 3D: local (ny, nx) planes per z-slice, all_to_all
    z-transpose, local z columns."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from pyfft_tpu.parallel.dist import make_dist_fft3

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs).reshape(2, 4), ("dp", "sp"))
    nz, ny, nx = 32, 16, 64
    rng = np.random.RandomState(6)
    x = (rng.standard_normal((2, nz, ny, nx))
         + 1j * rng.standard_normal((2, nz, ny, nx))).astype(np.complex64)
    fwd = make_dist_fft3(mesh, (nz, ny, nx))
    inv = make_dist_fft3(mesh, (nz, ny, nx), sign=+1, normalize=True)
    spec = NamedSharding(mesh, P("dp", "sp", None, None))
    re = jax.device_put(x.real.astype(np.float32), spec)
    im = jax.device_put(x.imag.astype(np.float32), spec)
    rr, ii = fwd(re, im)
    got = np.asarray(rr) + 1j * np.asarray(ii)
    ref = np.fft.fftn(x.astype(np.complex128), axes=(1, 2, 3))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6
    br, bi = inv(rr, ii)
    rt = np.asarray(br) + 1j * np.asarray(bi)
    assert np.abs(rt - x).max() / np.abs(x).max() < 2e-6


_MAKERS = {1: make_dist_fft, 2: make_dist_fft2, 3: make_dist_fft3}
_SHAPES = {1: (256,), 2: (16, 32), 3: (8, 4, 16)}


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("rank", [1, 2, 3], ids=["1D", "2D", "3D"])
def test_dist_parity_matrix(rank, dtype, dp, sp):
    """{1D, 2D, 3D} x {c64, c128} x mesh: forward vs numpy.fft, the
    normalized inverse back to the input, the unnormalized inverse to N x."""
    mesh = _mesh(dp, sp)
    shape = _SHAPES[rank]
    arg = shape[0] if rank == 1 else shape
    make = _MAKERS[rank]
    x = rand_complex((2,) + shape, dtype, seed=rank * 7 + sp)
    real_dt = np.float32 if dtype == np.complex64 else np.float64
    spec = NamedSharding(mesh, P("dp", "sp", *([None] * (rank - 1))))
    re = jax.device_put(x.real.astype(real_dt), spec)
    im = jax.device_put(x.imag.astype(real_dt), spec)
    fr, fi = make(mesh, arg)(re, im)
    assert fr.dtype == real_dt
    got = np.asarray(fr) + 1j * np.asarray(fi)
    axes = tuple(range(1, 1 + rank))
    ref = np.fft.fftn(x.astype(np.complex128), axes=axes)
    assert rel_err(got, ref) < TOL[dtype]
    br, bi = make(mesh, arg, sign=+1, normalize=True)(fr, fi)
    assert rel_err(np.asarray(br) + 1j * np.asarray(bi), x) < TOL[dtype]
    ur, ui = make(mesh, arg, sign=+1)(fr, fi)
    n = int(np.prod(shape))
    assert rel_err(np.asarray(ur) + 1j * np.asarray(ui), n * x) < TOL[dtype]


def _dot_precisions(jaxpr):
    """The precision of every dot_general in ``jaxpr``, sub-jaxprs included
    (the shard_map body is one)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


@pytest.mark.parametrize("rank", [1, 2, 3], ids=["1D", "2D", "3D"])
def test_dist_bodies_contract_at_highest_precision(rank):
    """Every dot_general in a dist body asks for HIGHEST precision (or the
    body has none): the CPU-checkable stand-in for "no TF32 on the card"."""
    mesh = _mesh(1, 4)
    shape = _SHAPES[rank]
    arg = shape[0] if rank == 1 else shape
    ex = jax.ShapeDtypeStruct((2,) + shape, np.float32)
    for sign in (-1, +1):
        jaxpr = jax.make_jaxpr(_MAKERS[rank](mesh, arg, sign=sign))(ex, ex)
        precisions = _dot_precisions(jaxpr.jaxpr)
        if rank == 1:
            assert precisions, "the 1D body's cross-device DFT is a dot"
        for prec in precisions:
            pair = prec if isinstance(prec, tuple) else (prec, prec)
            assert all(p == jax.lax.Precision.HIGHEST for p in pair), prec
