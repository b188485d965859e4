"""The port's SSD scan against the JAX package's: the plain chunked
version (what the CPU runs), the sequential oracle and the decode step,
on the sweep shapes of tests/test_kernels.py, with the JAX Pallas kernel
run in interpret mode.

Both sides compute in f32 from the same inputs (bf16 inputs are the same
bf16 values on both sides), in another order of sums: 3e-4 in f32 and
4e-2 in bf16 (atol = rtol), test_kernels.py's bars; the bf16 bar covers
the one rounding of y to bf16 that each side makes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd as j_ssd  # noqa: E402
from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import \
    ssd_decode_step as j_decode  # noqa: E402
from repro_torch.kernels import ssd_scan as ts  # noqa: E402

SWEEP = [
    (1, 64, 2, 1, 16, 8, 16, "float32"),
    (2, 128, 4, 2, 32, 16, 32, "float32"),
    (1, 64, 2, 1, 16, 8, 64, "float32"),     # chunk == S
    (1, 64, 2, 1, 16, 8, 16, "bfloat16"),
]
TOL = {"float32": 3e-4, "bfloat16": 4e-2}


def case(b, s, h, g, n, p, dtype, seed, a_range=(0.5, 2.0),
         dt_range=(0.01, 0.2)):
    """The same inputs for both packages, drawn as test_kernels.py draws
    them: (jax arrays, torch tensors) of (x, dt, a, b, c, d)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.dtype(dtype)
    raw = [rng.standard_normal((b, s, h, p)),
           rng.uniform(*dt_range, (b, s, h)),
           -rng.uniform(*a_range, (h,)),
           rng.standard_normal((b, s, g, n)) * 0.3,
           rng.standard_normal((b, s, g, n)) * 0.3,
           rng.standard_normal(h) * 0.1]
    types = [jdt, jnp.float32, jnp.float32, jdt, jdt, jnp.float32]
    jax_in = [jnp.asarray(v, t) for v, t in zip(raw, types)]
    tdt = getattr(torch, dtype)
    torch_in = [torch.from_numpy(np.array(v, np.float32)).to(
        tdt if t == jdt else torch.float32)
        for v, t in zip(jax_in, types)]
    return jax_in, torch_in


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,g,n,p,chunk,dtype", SWEEP)
def test_ssd_matches_reference(b, s, h, g, n, p, chunk, dtype):
    (jx, jdt_, ja, jb, jc, jd), args = case(b, s, h, g, n, p, dtype, s + h)
    want_kernel = j_ssd_scan(jx, jdt_, ja, jb, jc, jd, chunk=chunk,
                             interpret=True)
    want_ref, want_state = j_ssd_ref(jx, jdt_, ja, jb, jc, jd)
    want_jnp = j_ssd(jx, jdt_, ja, jb, jc, jd, chunk=chunk, use_kernel=False)
    tol = TOL[dtype]
    got_chunked = ts.ssd_chunked(*args, chunk)
    got_ref, got_state = ts.ssd_ref(*args)
    got_ops = ts.ssd(*args, chunk=chunk)
    got_wrapper = ts.ssd_scan(*args, chunk=chunk)
    for got in (got_chunked, got_ref, got_ops, got_wrapper):
        assert got.dtype == args[0].dtype and got.shape == args[0].shape
        for want in (want_kernel, want_ref, want_jnp):
            np.testing.assert_allclose(f32(got), f32(want), atol=tol,
                                       rtol=tol)
    # the CPU path is the plain chunked version, exactly
    assert torch.equal(got_ops, got_chunked)
    assert torch.equal(got_wrapper, got_chunked)
    assert got_state.dtype == torch.float32
    np.testing.assert_allclose(f32(got_state), f32(want_state), atol=3e-4,
                               rtol=3e-4)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference_and_scan(g):
    b, s, h, n, p = 2, 16, 4, 8, 4
    (jx, jdt_, ja, jb, jc, jd), (x, dt, a, bm, cm, d) = case(
        b, s, h, g, n, p, "float32", 10 + g)
    y_full, final = ts.ssd_ref(x, dt, a, bm, cm, d)
    state = torch.zeros((b, h, n, p))
    jstate = jnp.zeros((b, h, n, p), jnp.float32)
    for t in range(s):
        y_t, state = ts.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                        bm[:, t], cm[:, t], d)
        jy, jstate = j_decode(jstate, jx[:, t], jdt_[:, t], ja, jb[:, t],
                              jc[:, t], jd)
        np.testing.assert_allclose(f32(y_t), f32(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(f32(state), f32(jstate), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(f32(y_t), f32(y_full[:, t]), atol=2e-4,
                                   rtol=2e-4)
    np.testing.assert_allclose(f32(state), f32(final), atol=1e-5, rtol=1e-5)


def test_ssd_chunked_underflow_stays_finite():
    """a = -16 and dt up to 2 take cum to about -1000 inside a chunk, so
    exp(cum) underflows to 0: the chunked form stays finite and equal to
    the recurrence."""
    _, args = case(1, 128, 2, 1, 16, 8, "float32", 3, a_range=(15.0, 16.0),
                   dt_range=(0.5, 2.0))
    y = ts.ssd_chunked(*args, 64)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(f32(y), f32(ts.ssd_ref(*args)[0]), atol=3e-4,
                               rtol=3e-4)


def test_ssd_chunk_is_cut_to_s_and_must_divide_it():
    _, args = case(1, 48, 2, 1, 16, 8, "float32", 5)
    # chunk 64 > S = 48: cut to 48, as the reference does
    np.testing.assert_allclose(f32(ts.ssd(*args)), f32(ts.ssd_ref(*args)[0]),
                               atol=3e-4, rtol=3e-4)
    with pytest.raises(ValueError, match="multiple"):
        ts.ssd(*args, chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        ts.ssd_scan(*args, chunk=32)
    x, dt, a, b, c, d = args
    with pytest.raises(ValueError):
        ts.ssd(x, dt[:, :-1], a, b, c, d)
    with pytest.raises(ValueError, match="multiple of G"):
        ts.ssd(x, dt, a, b.expand(1, 48, 3, 16), c.expand(1, 48, 3, 16), d)
