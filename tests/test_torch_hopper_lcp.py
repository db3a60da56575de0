"""PyTorch port: the PPM LCP kernel's plain version and wrapper
(`moby_tpu_torch.solvers.hopper_lcp`) against the Pallas kernel of
`moby_tpu.solvers.pallas_lcp`, run in interpret mode as the JAX package's own
tests run it on the CPU.

Tolerances: kernel and plain version follow the same pivots, so on float64
data z agrees to 1e-9·max(1, ‖z‖∞) (the Pallas kernel's in-kernel reductions
sum in another order than a batched matmul); float32 data is held to
2e-3·max(1, ‖z‖∞). `done` must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.solvers import lcp as jlcp
from moby_tpu.solvers import pallas_lcp
from moby_tpu_torch.solvers import hopper_lcp
from moby_tpu_torch.solvers import lcp as tlcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_kkt, make_monotone, t2n


def _cases(dtype, n=12, B=7, seed=2):
    M, q = make_monotone(B, n, seed, dtype)
    Mk, qk = make_kkt(2, n - 4, 4, seed, dtype)
    M[5:7], q[5:7] = Mk, qk
    mask = np.ones((B, n), bool)
    mask[1, n - 4:] = False
    mask[2] = False                      # all-false mask: trivial, done, z=0
    q[3] = np.abs(q[3]) + 0.1            # q > 0: trivial
    mask[4] = np.random.default_rng(seed).uniform(size=n) < 0.5
    return M, q, mask


def _tol(dtype, z):
    return (1e-9 if dtype == np.float64 else 2e-3) * max(1.0, np.abs(z).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_plain_matches_pallas_batched_cold(dtype):
    M, q, mask = _cases(dtype)
    zj, okj = pallas_lcp.ppm_lcp_batched(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), interpret=True)
    zt, okt = hopper_lcp.ppm_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert t2n(okt).all()
    assert np.all(t2n(zt)[2] == 0) and np.all(t2n(zt)[3] == 0)
    np.testing.assert_allclose(t2n(zt), np.asarray(zj), atol=_tol(dtype, t2n(zt)),
                               rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("warm", ["solution", "garbage", "zeros"])
def test_plain_matches_pallas_warm_one(dtype, warm):
    M, q, mask = _cases(dtype)
    zc, _ = hopper_lcp.ppm_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    if warm == "solution":
        z0 = t2n(zc)
    elif warm == "garbage":
        z0 = np.abs(np.random.default_rng(8).normal(size=q.shape)).astype(dtype)
        z0[:, ::2] = 0.0
    else:
        z0 = np.zeros_like(q)
    zj, okj = jax.vmap(
        lambda M_, q_, m_, z_: pallas_lcp.ppm_lcp_one(M_, q_, m_, z0=z_,
                                                       interpret=True)
    )(jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(z0))
    zt, okt = hopper_lcp.ppm_lcp(          # CPU tensors: the wrapper's plain route
        torch.tensor(M), torch.tensor(q), torch.tensor(mask), z0=torch.tensor(z0))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert t2n(okt).all()
    tol = _tol(dtype, t2n(zt))
    np.testing.assert_allclose(t2n(zt), np.asarray(zj), atol=tol, rtol=0)
    np.testing.assert_allclose(t2n(zt), t2n(zc), atol=10 * tol, rtol=0)


def test_plain_singular_problem_agrees_on_done():
    """A singular problem: a zero active row/column makes the sub-solve skip
    its pivot (|pivot| <= 1e-30) in both versions; `done` and z agree."""
    M, q = make_monotone(2, 8, 4)
    M[0, 2, :] = 0.0
    M[0, :, 2] = 0.0
    q[0, 2] = -1.0            # wants to enter, but its pivot vanishes
    mask = np.ones((2, 8), bool)
    zj, okj = pallas_lcp.ppm_lcp_batched(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), interpret=True)
    zt, okt = hopper_lcp.ppm_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    np.testing.assert_allclose(t2n(zt), np.asarray(zj), atol=1e-9, rtol=0)


def test_plain_nan_propagates_to_not_done():
    """jnp.min propagates NaN: a NaN in M poisons z and the problem ends
    with done=0 and z=0, in the Pallas kernel and in the plain version."""
    M, q = make_monotone(2, 6, 6)
    M[0, 1, 3] = np.nan
    q[0] = -np.abs(q[0])
    mask = np.ones((2, 6), bool)
    zj, okj = pallas_lcp.ppm_lcp_batched(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), interpret=True)
    zt, okt = hopper_lcp.ppm_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert not t2n(okt)[0] and t2n(okt)[1]
    assert np.all(t2n(zt)[0] == 0)


@pytest.mark.parametrize("solver", ["solve_lcp", "solve_lcp_fast_lemke"])
def test_accel_cascade_matches_jax(solver, monkeypatch):
    """The port's accelerated cascade (BPP -> PPM -> plain), forced on the
    CPU with the plain PPM in the kernel's place, against the JAX package's
    `_solve_accel` forced with MOBY_PALLAS_LCP=1 (interpret mode), float32.
    2e-3·max(1, ‖z‖∞): matmul summation order in float32."""
    monkeypatch.setenv("MOBY_PALLAS_LCP", "1")
    B, n = 5, 16
    M, q = make_monotone(B, n, 13, np.float32)
    Mk, qk = make_kkt(2, 11, 5, 13, np.float32)
    M[3:], q[3:] = Mk, qk
    mask = np.ones((B, n), bool)
    mask[:, 13:] = False
    mask[3:] = True
    z0 = np.zeros((B, n), np.float32)
    skip = np.zeros(B, bool)
    skip[1] = True
    zj, okj = jax.vmap(
        lambda M_, q_, m_, z_, s_: getattr(jlcp, solver)(M_, q_, m_, z0=z_, skip=s_)
    )(jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(z0),
      jnp.asarray(skip))
    kw = {"device": "cpu"} if solver == "solve_lcp" else {}
    before = hopper_lcp.ppm_lcp.launches
    zt, okt = getattr(tlcp, solver)(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask),
        z0=torch.tensor(z0), skip=torch.tensor(skip), cascade="accel", **kw)
    assert hopper_lcp.ppm_lcp.launches == before     # no kernel on the CPU
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert t2n(okt)[[0, 2, 3, 4]].all() and not t2n(okt)[1]
    np.testing.assert_allclose(t2n(zt), np.asarray(zj),
                               atol=_tol(np.float32, t2n(zt)), rtol=0)


def test_accel_cascade_reaches_ppm_when_bpp_fails(monkeypatch):
    """With BPP made to fail (0 iterations), stage 2 must solve: the PPM
    stage is really wired into the cascade."""
    M, q = make_monotone(4, 10, 21)
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mask = torch.ones(4, 10, dtype=torch.bool)
    calls = []
    real = hopper_lcp.ppm_lcp

    def spy(M_, q_, m_, z0=None, max_piv=None):
        calls.append(int(m_.any(dim=1).sum()))
        return real(M_, q_, m_, z0=z0, max_piv=max_piv)

    monkeypatch.setattr(hopper_lcp, "ppm_lcp", spy)
    orig_bpp = tlcp.lcp_bpp
    monkeypatch.setattr(
        tlcp, "lcp_bpp",
        lambda *a, **k: orig_bpp(*a, **{**k, "max_iters": 0}))
    z, ok = tlcp.solve_lcp(Mt, qt, mask, cascade="accel", device="cpu")
    z_ref, ok_ref = tlcp.lcp_fast(Mt, qt, mask)
    assert calls and calls[0] >= 1
    assert bool(ok.all()) and bool(ok_ref.all())
    np.testing.assert_allclose(t2n(z), t2n(z_ref), atol=1e-9, rtol=0)


def test_size_gate_and_wrapper_checks():
    assert hopper_lcp.padded_size(66) == 96 and hopper_lcp.padded_size(6) == 32
    assert hopper_lcp.fits(66, torch.float32) and hopper_lcp.fits(66, torch.float64)
    assert hopper_lcp.fits(160, torch.float32)
    assert not hopper_lcp.fits(161, torch.float32)
    assert hopper_lcp.fits(96, torch.float64)
    assert not hopper_lcp.fits(97, torch.float64)
    assert hopper_lcp.smem_bytes(66, torch.float32) == (2 * 96 * 96 + 4 * 96) * 4 + 3 * 96 * 4


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """Kernel against plain version on the card (skipped without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU interpreter")
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-10)):
        M, q, mask = _cases(dtype, n=66, B=64)
        Mt, qt, mt = (torch.tensor(x, device="cuda") for x in (M, q, mask))
        zk, okk = hopper_lcp.ppm_lcp(Mt, qt, mt)
        zp, okp = hopper_lcp.ppm_lcp_plain(Mt, qt, mt)
        torch.cuda.synchronize()
        assert bool((okk == okp).all())
        scale = max(1.0, float(zp.abs().max()))
        assert float((zk - zp).abs().max()) <= tol * scale
