"""Plan API tests: the reference's public contract (SURVEY.md §2.9-bis),
including the five BASELINE acceptance configs at reduced sizes plus the
full-size CPU-runnable ones."""

import numpy as np
import pytest

from pyfft_tpu import Plan
from pyfft_tpu.api import fft, fft2, fftn, ifft

from helpers import TOL, rand_complex, rel_err


def test_int_shape():
    x = rand_complex((64,))
    p = Plan(64)
    assert rel_err(p.execute(x), np.fft.fft(x)) < TOL[np.complex64]


def test_non_power_of_two_raises():
    with pytest.raises(ValueError):
        Plan((24,))
    with pytest.raises(ValueError):
        Plan((16, 24))


def test_bad_rank_raises():
    with pytest.raises(ValueError):
        Plan((2, 2, 2, 2))


def test_bad_dtype_raises():
    with pytest.raises(ValueError):
        Plan((16,), dtype=np.float32)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_roundtrip_1d(dtype):
    """BASELINE config 1: N=1024 batch=1 forward+inverse roundtrip."""
    x = rand_complex((1024,), dtype)
    plan = Plan((1024,), dtype)
    fwd = plan.execute(x)
    assert rel_err(fwd, np.fft.fft(x.astype(np.complex128))) < TOL[dtype]
    rt = plan.execute(fwd, inverse=True)
    assert rel_err(rt, x) < TOL[dtype]


def test_batched_1d():
    """BASELINE config 2 (reduced batch): batched interleaved 1D."""
    x = rand_complex((32, 4096))
    plan = Plan((4096,))
    out = plan.execute(x)
    assert rel_err(out, np.fft.fft(x.astype(np.complex128), axis=-1)) \
        < TOL[np.complex64]


def test_2d_batched():
    """BASELINE config 3 (reduced): 2D with batch."""
    x = rand_complex((4, 256, 256))
    plan = Plan((256, 256))
    out = plan.execute(x)
    ref = np.fft.fft2(x.astype(np.complex128))
    assert rel_err(out, ref) < TOL[np.complex64]


def test_3d():
    """BASELINE config 4 (reduced): 3D single batch."""
    x = rand_complex((64, 64, 64))
    plan = Plan((64, 64, 64))
    out = plan.execute(x)
    ref = np.fft.fftn(x.astype(np.complex128))
    assert rel_err(out, ref) < TOL[np.complex64]


def test_large_1d_c128_split():
    """BASELINE config 5 (reduced): large 1D c128, split complex, batch."""
    n = 2**16
    x = rand_complex((4, n), np.complex128, seed=11)
    plan = Plan((n,), np.complex128)
    rr, ii = plan.execute(np.real(x).copy(), np.imag(x).copy())
    got = np.asarray(rr) + 1j * np.asarray(ii)
    ref = np.fft.fft(x, axis=-1)
    assert rel_err(got, ref) < TOL[np.complex128]
    br, bi = plan.execute(rr, ii, inverse=True)
    assert rel_err(np.asarray(br) + 1j * np.asarray(bi), x) < TOL[np.complex128]


def test_flat_buffer_batch():
    """Reference-style: flat buffer + batch=k (SURVEY.md §2.9-bis)."""
    x = rand_complex((8 * 512,), seed=9)
    plan = Plan((512,))
    out = plan.execute(x, batch=8)
    assert out.shape == x.shape
    ref = np.fft.fft(x.reshape(8, 512).astype(np.complex128)).reshape(-1)
    assert rel_err(out, ref) < TOL[np.complex64]


def test_batch_mismatch_raises():
    plan = Plan((512,))
    with pytest.raises(ValueError):
        plan.execute(rand_complex((1000,)), batch=2)


def test_normalize_off():
    x = rand_complex((256,), seed=10)
    plan = Plan((256,), normalize=False)
    rt = plan.execute(plan.execute(x), inverse=True)
    assert rel_err(rt, x * 256) < TOL[np.complex64]


def test_scale():
    x = rand_complex((128,), seed=12)
    plan = Plan((128,), scale=0.5)
    out = plan.execute(x)
    assert rel_err(out, 0.5 * np.fft.fft(x.astype(np.complex128))) \
        < TOL[np.complex64]


def test_split_interleaved_agree():
    x = rand_complex((2, 1024), seed=13)
    plan = Plan((1024,))
    inter = np.asarray(plan.execute(x))
    rr, ii = plan.execute(np.real(x).copy(), np.imag(x).copy())
    split = np.asarray(rr) + 1j * np.asarray(ii)
    assert rel_err(split, inter) < 1e-6


def test_wait_for_finish_async():
    x = rand_complex((256,), seed=14)
    plan = Plan((256,), wait_for_finish=False)
    out = plan.execute(x)         # async dispatch
    out.block_until_ready()
    assert rel_err(out, np.fft.fft(x.astype(np.complex128))) < TOL[np.complex64]


def test_functional_api():
    x = rand_complex((4, 512), seed=15)
    assert rel_err(fft(x), np.fft.fft(x.astype(np.complex128))) < TOL[np.complex64]
    assert rel_err(ifft(fft(x)), x) < TOL[np.complex64]
    y = rand_complex((8, 32, 64), seed=16)
    assert rel_err(fft2(y), np.fft.fft2(y.astype(np.complex128))) < TOL[np.complex64]
    assert rel_err(fftn(y), np.fft.fftn(y.astype(np.complex128))) < TOL[np.complex64]


def test_backend_shims():
    """pyfft_tpu.cpu.Plan is the package's Plan (the pyfft.cl analog)."""
    from pyfft_tpu import cpu
    assert cpu.Plan is Plan
    x = rand_complex((512,), seed=17)
    ref = np.fft.fft(x.astype(np.complex128))
    assert rel_err(cpu.Plan((512,)).execute(x), ref) < TOL[np.complex64]


def test_repr():
    assert repr(Plan((1024,))) == "Plan(shape=(1024,), dtype=complex64)"


def test_donate_plan():
    import jax.numpy as jnp
    x = rand_complex((8, 256), seed=23)
    plan = Plan((256,), donate=True)
    re = jnp.asarray(np.real(x).copy())
    im = jnp.asarray(np.imag(x).copy())
    rr, ii = plan.execute(re, im)
    got = np.asarray(rr) + 1j * np.asarray(ii)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(got, ref) < TOL[np.complex64]


def test_multipass_inverse_normalize():
    """Regression: on a 2D plan the inverse 1/N normalization and the user
    scale must both survive (an early version dropped 1/N on every
    multi-axis inverse)."""
    x = rand_complex((128, 256), seed=77)
    plan = Plan((128, 256))
    rr, ii = plan.execute(np.real(x).astype(np.float32),
                          np.imag(x).astype(np.float32))
    br, bi = plan.execute(rr, ii, inverse=True)
    rt = np.asarray(br) + 1j * np.asarray(bi)
    ref = np.fft.ifftn(np.fft.fftn(x.astype(np.complex128)))
    assert rel_err(rt, ref) < TOL[np.complex64]
    # user scale on a multi-pass forward
    plan_s = Plan((128, 256), scale=0.25)
    sr, si = plan_s.execute(np.real(x).astype(np.float32),
                            np.imag(x).astype(np.float32))
    got = np.asarray(sr) + 1j * np.asarray(si)
    assert rel_err(got, 0.25 * np.fft.fftn(x.astype(np.complex128))) \
        < TOL[np.complex64]


def test_fast_math_false_large_n_still_works():
    """fast_math is accepted for API familiarity and changes nothing:
    cuFFT has no fast-math switch."""
    x = rand_complex((4, 4096), seed=41)
    out = Plan((4096,), fast_math=False).execute(x)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(out, ref) < TOL[np.complex64]
    same = Plan((4096,), fast_math=True).execute(x)
    assert np.array_equal(np.asarray(out), np.asarray(same))


def test_warmup_compiles():
    """pyfft_tpu.warmup precompiles plan executables (the persistent
    cache's placement is covered in test_cache.py)."""
    import pyfft_tpu

    n = pyfft_tpu.warmup([64, (32, 32)], batches=(1, 4))
    assert n == 2 * 2 * 2  # shapes x batches x directions
    x = rand_complex((4, 64), seed=50)
    out = Plan((64,)).execute(x)
    assert rel_err(out, np.fft.fft(x.astype(np.complex128), axis=-1)) \
        < TOL[np.complex64]


def test_api_axis_kwargs():
    """numpy-style axis/axes selection on the functional API."""
    rng = np.random.RandomState(60)
    x = (rng.standard_normal((8, 64, 4))
         + 1j * rng.standard_normal((8, 64, 4))).astype(np.complex64)
    got = fft(x, axis=1)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert rel_err(got, ref) < TOL[np.complex64]
    got = fft2(np.swapaxes(x, 0, 2), axes=(2, 1))
    ref = np.fft.fftn(np.swapaxes(x, 0, 2).astype(np.complex128),
                      axes=(2, 1))
    assert rel_err(got, ref) < TOL[np.complex64]
    got = fftn(x, axes=(1,))
    assert rel_err(got, np.fft.fft(x.astype(np.complex128), axis=1)) \
        < TOL[np.complex64]
    with pytest.raises(ValueError):
        fftn(x, axes=(1, 1))


def test_api_axis_validation():
    """Out-of-range / wrong-arity axes raise instead of silently wrapping
    (review finding: axis=2 on a 2D array used to transform axis 0)."""
    x = rand_complex((8, 64))
    with pytest.raises(ValueError):
        fft(x, axis=2)
    with pytest.raises(ValueError):
        fft(x, axis=-3)
    with pytest.raises(ValueError):
        fft2(x, axes=(0,))
    with pytest.raises(ValueError):
        fftn(x, axes=(0, 1, 0))
