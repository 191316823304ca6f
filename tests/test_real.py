"""Real-to-complex transforms (beyond-parity feature): parity vs
numpy.fft.rfft/irfft/rfftn, roundtrips, device residency / jit
composability, error cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfft_tpu import (irfft, irfft2, irfft_planar, irfftn, rfft, rfft2,
                       rfft_planar, rfftn, rfftn_planar)

from helpers import TOL

C64 = TOL[np.complex64]


def rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape", [(4,), (256,), (8, 1024), (3, 2, 512)])
def test_rfft_parity(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.standard_normal(shape)
    got = rfft(x)
    ref = np.fft.rfft(x, axis=-1)
    assert got.shape == shape[:-1] + (shape[-1] // 2 + 1,)
    assert rel(got, ref) < C64


@pytest.mark.parametrize("n", [8, 512])
def test_irfft_roundtrip(n):
    rng = np.random.RandomState(n)
    x = rng.standard_normal((5, n))
    back = irfft(rfft(x))
    assert back.shape == x.shape
    assert rel(back, x) < C64


def test_irfft_matches_numpy():
    rng = np.random.RandomState(7)
    X = np.fft.rfft(rng.standard_normal((2, 256)), axis=-1)
    got = irfft(X.astype(np.complex64))
    ref = np.fft.irfft(X, axis=-1)
    assert rel(got, ref) < C64


def test_rfft_errors():
    with pytest.raises(ValueError):
        rfft(np.zeros(24))
    with pytest.raises(ValueError):
        rfft(np.zeros(2))
    with pytest.raises(ValueError):
        irfft(np.zeros(100, np.complex64))


def test_rfft_rejects_scaling_kwargs():
    # normalize/scale would silently break the untangle algebra (ADVICE r2)
    with pytest.raises(ValueError):
        rfft(np.zeros(64), normalize=False)
    with pytest.raises(ValueError):
        irfft(np.zeros(33, np.complex64), scale=2.0)
    with pytest.raises(ValueError):
        rfftn(np.zeros((8, 64)), scale=0.5)
    # force_xla chose between executors that no longer exist
    with pytest.raises(ValueError):
        rfft(np.zeros(64), force_xla=True)


# ------------------------------------------------------------------- N-D


@pytest.mark.parametrize("shape", [(64, 128), (4, 32, 64)])
def test_rfft2_parity(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.standard_normal(shape)
    got = rfft2(x)
    ref = np.fft.rfftn(x, axes=(-2, -1))
    assert got.shape == shape[:-1] + (shape[-1] // 2 + 1,)
    assert rel(got, ref) < C64


def test_rfftn_3d_parity():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((16, 32, 64))
    got = rfftn(x)
    ref = np.fft.rfftn(x)
    assert rel(got, ref) < C64


def test_rfftn_default_rank_caps_at_3():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 8, 16, 32))
    got = rfftn(x)      # transforms the last 3 axes, batch over the first
    ref = np.fft.rfftn(x, axes=(1, 2, 3))
    assert rel(got, ref) < C64


@pytest.mark.parametrize("shape", [(32, 64), (4, 16, 128)])
def test_irfftn_roundtrip(shape):
    rng = np.random.RandomState(len(shape))
    x = rng.standard_normal(shape)
    back = irfftn(rfftn(x, len(shape)), len(shape))
    assert np.asarray(back).shape == x.shape
    assert rel(back, x) < C64


def test_irfft2_matches_numpy():
    rng = np.random.RandomState(9)
    X = np.fft.rfftn(rng.standard_normal((64, 32)), axes=(0, 1))
    got = irfft2(X.astype(np.complex64))
    ref = np.fft.irfftn(X, axes=(0, 1))
    assert rel(got, ref) < C64


# -------------------------------------------------- device residency/jit


def test_rfft_planar_is_jittable():
    rng = np.random.RandomState(11)
    x = rng.standard_normal((8, 256)).astype(np.float32)

    @jax.jit
    def pipeline(v):
        # rfft -> spectral scaling -> irfft, all in one traced program
        xr, xi = rfft_planar(v)
        return irfft_planar(2.0 * xr, 2.0 * xi)

    got = pipeline(jnp.asarray(x))
    assert isinstance(got, jax.Array)
    assert rel(got, 2.0 * x) < C64


def test_rfftn_planar_is_jittable_and_matches():
    rng = np.random.RandomState(12)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    xr, xi = jax.jit(lambda v: rfftn_planar(v, 2))(jnp.asarray(x))
    ref = np.fft.rfftn(x, axes=(0, 1))
    got = np.asarray(xr) + 1j * np.asarray(xi)
    assert rel(got, ref) < C64


def test_irfft_returns_device_array():
    X = np.fft.rfft(np.random.RandomState(5).standard_normal((2, 64)))
    out = irfft(X.astype(np.complex64))
    assert isinstance(out, jax.Array)
