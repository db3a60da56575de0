"""PyTorch port: the BPP+PPM LCP kernel's plain version and wrapper
(`moby_tpu_torch.solvers.hopper_lcp.bpp_lcp`) against the Pallas kernel of
`moby_tpu.solvers.pallas_lcp`, run in interpret mode as the JAX package's own
tests run it on the CPU, and `lcp.gj_invert_masked`/`gj_invert_pd` against
the JAX functions.

Tolerances: the plain version follows the Pallas kernel's iterations, so on
float64 data `ok` is equal and z agrees to 1e-10·max(1, ‖z‖∞) (the in-kernel
reductions sum in another order than a batched matmul); float32 data is held
to 2e-3·max(1, ‖z‖∞). The Gauss–Jordan inverses run the same eliminations in
the same order: 1e-12 relative in float64.
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


def _tol(dtype, z):
    return (1e-10 if dtype == np.float64 else 2e-3) * max(1.0, np.abs(z).max())


def _both(M, q, mask, z0=None, **kw):
    zj, okj = pallas_lcp.bpp_lcp_batched(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask),
        z0s=None if z0 is None else jnp.asarray(z0), interpret=True, **kw)
    zt, okt = hopper_lcp.bpp_lcp(          # CPU tensors: the wrapper's plain route
        torch.tensor(M), torch.tensor(q), torch.tensor(mask),
        z0=None if z0 is None else torch.tensor(z0), **kw)
    return np.asarray(zj), np.asarray(okj), t2n(zt), t2n(okt)


# the cases of tests/test_pallas_lcp.py::TestPallasBPP: (B, n, seed, n_true)
PALLAS_CASES = {
    "matches_xla_solver": (8, 12, 0, 12),
    "complementarity_and_verify": (6, 20, 3, 20),
    "masked_padding": (4, 16, 5, 9),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_plain_matches_pallas_cold_and_warm(case, dtype):
    B, n, seed, n_true = PALLAS_CASES[case]
    M, q = make_monotone(B, n, seed, dtype)
    mask = np.zeros((B, n), bool)
    mask[:, :n_true] = True
    zj, okj, zt, okt = _both(M, q, mask)
    np.testing.assert_array_equal(okt, okj)
    assert okt.all()
    np.testing.assert_allclose(zt, zj, atol=_tol(dtype, zt), rtol=0)
    assert np.all(zt[:, n_true:] == 0)
    # complementarity of what is called ok
    w = np.einsum("bij,bj->bi", M.astype(np.float64), zt.astype(np.float64)) + q
    assert zt.min() > -1e-4 and w[mask].min() > -1e-3
    assert np.abs(zt * w)[mask].max() < 1e-2
    # warm from the solution reproduces it, in both
    zjw, okjw, ztw, oktw = _both(M, q, mask, z0=zt)
    np.testing.assert_array_equal(oktw, okjw)
    assert oktw.all()
    np.testing.assert_allclose(ztw, zjw, atol=_tol(dtype, zt), rtol=0)
    np.testing.assert_allclose(ztw, zt, atol=10 * _tol(dtype, zt), rtol=0)


@pytest.mark.parametrize("which", ["empty_mask", "q_positive"])
def test_plain_trivial_cases(which):
    B, n = 3, 8
    M, q = make_monotone(B, n, 7)
    mask = np.ones((B, n), bool)
    if which == "empty_mask":
        mask[:] = False
    else:
        q = np.ones_like(q)
    z0 = np.abs(np.random.default_rng(1).normal(size=q.shape))
    for warm in (None, z0 if which == "empty_mask" else None):
        zj, okj, zt, okt = _both(M, q, mask, z0=warm)
        assert okj.all() and okt.all()
        assert np.all(zt == 0) and np.all(zj == 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_plain_mixed_batch_kkt_partial_masks_garbage_warm(dtype):
    """Monotone and KKT-shaped problems, a partial mask, an all-false mask,
    q > 0 and a warm start that is not a solution, in one batch."""
    B, n = 7, 12
    M, q = make_monotone(B, n, 2, dtype)
    Mk, qk = make_kkt(2, n - 4, 4, 2, dtype)
    M[5:7], q[5:7] = Mk, qk
    mask = np.ones((B, n), bool)
    mask[1, n - 4:] = False
    mask[2] = False
    q[3] = np.abs(q[3]) + 0.1
    mask[4] = np.random.default_rng(2).uniform(size=n) < 0.5
    z0 = np.abs(np.random.default_rng(8).normal(size=q.shape)).astype(dtype)
    z0[:, ::2] = 0.0
    for warm in (None, z0):
        zj, okj, zt, okt = _both(M, q, mask, z0=warm)
        np.testing.assert_array_equal(okt, okj)
        assert okt.all()
        np.testing.assert_allclose(zt, zj, atol=_tol(dtype, zt), rtol=0)


def test_plain_ppm_stage_finishes_when_bpp_runs_out():
    """max_bpp=1: the block stage cannot finish problems that need more than
    one iteration; the PPM stage takes over from its basis and the result is
    the cold 24-iteration solution."""
    B, n = 8, 12
    M, q = make_monotone(B, n, 0)
    mask = np.ones((B, n), bool)
    zj, okj, zt, okt = _both(M, q, mask, max_bpp=1)
    np.testing.assert_array_equal(okt, okj)
    assert okt.all()
    np.testing.assert_allclose(zt, zj, atol=_tol(np.float64, zt), rtol=0)
    _, _, iters, pivots, _ = hopper_lcp.bpp_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask), max_bpp=1,
        with_pivots=True)
    assert int(iters.max()) == 1 and int(pivots.sum()) > 0
    z_full, ok_full = hopper_lcp.bpp_lcp_plain(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    assert bool(ok_full.all())
    np.testing.assert_allclose(zt, t2n(z_full), atol=1e-9, rtol=0)
    # out of both budgets: not ok, z = 0, in both
    zj, okj, zt, okt = _both(M, q, mask, max_bpp=1, max_piv=0)
    np.testing.assert_array_equal(okt, okj)
    assert not okt.all()
    assert np.all(zt[~okt] == 0) and np.all(zj[~okj] == 0)


def test_plain_nan_and_singular_agree_on_ok():
    """A NaN in q has no violator (comparisons with NaN are false), so the
    block stage calls itself finished and only the check's NaN-propagating
    minima give ok=0; a NaN in M makes every tolerance NaN, the start set
    empty and the problem 'trivial' (ok=1, z=0), in the Pallas kernel and in
    the plain version alike. A zero active row/column skips its pivot."""
    M, q = make_monotone(4, 6, 6)
    q[0] = -np.abs(q[0])
    q[0, 2] = np.nan
    M[1, 1, 3] = np.nan
    M[2, 2, :] = 0.0
    M[2, :, 2] = 0.0
    q[2, 2] = -1.0
    mask = np.ones((4, 6), bool)
    zj, okj, zt, okt = _both(M, q, mask)
    np.testing.assert_array_equal(okt, okj)
    assert not okt[0] and okt[1] and okt[3]
    assert np.all(zt[1] == 0)
    fin = np.isfinite(zj) & np.isfinite(zt)
    np.testing.assert_array_equal(np.isfinite(zj), np.isfinite(zt))
    np.testing.assert_allclose(zt[fin], zj[fin], atol=1e-10, rtol=0)


def test_plain_agrees_with_batched_bpp_and_verify():
    """One call of `bpp_lcp` stands for a `lcp_bpp` + `_verify` pair: on
    strictly monotone problems both verify and give the same z (1e-9)."""
    B, n = 6, 14
    M, q = make_monotone(B, n, 17)
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mask = torch.ones(B, n, dtype=torch.bool)
    mask[0, 9:] = False
    z, ok = hopper_lcp.bpp_lcp(Mt, qt, mask, max_bpp=12)
    Mp, qp = tlcp.pad_lcp(Mt, qt, mask)
    z_ref, ok_ref = tlcp.lcp_bpp(Mt, qt, mask, max_iters=12)
    ok_ref = ok_ref & tlcp._verify(Mp, qp, z_ref, mask, tlcp._check_tol(Mp, mask))
    assert bool(ok.all()) and bool(ok_ref.all())
    np.testing.assert_allclose(t2n(z), t2n(z_ref), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_gj_invert_masked_matches_jax(dtype):
    B, n = 5, 9
    M, _ = make_monotone(B, n, 23, dtype)
    active = np.random.default_rng(23).uniform(size=(B, n)) < 0.7
    active[0] = True
    outer = active[:, :, None] & active[:, None, :]
    A = np.where(outer, M, 0) + np.eye(n, dtype=dtype) * (~active)[:, None, :]
    A[1, 2, :] = 0.0   # a vanishing pivot: ok=False there, in both
    A[1, :, 2] = 0.0
    active[1, 2] = True
    Aj, okj = jax.vmap(jlcp.gj_invert_masked)(jnp.asarray(A), jnp.asarray(active))
    At, okt = tlcp.gj_invert_masked(torch.tensor(A), torch.tensor(active))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert not t2n(okt)[1] and t2n(okt)[0]
    rt = 1e-12 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(t2n(At), np.asarray(Aj), rtol=rt,
                               atol=rt * np.abs(np.asarray(Aj)).max())
    good = t2n(okt)
    np.testing.assert_allclose(
        np.einsum("bij,bjk->bik", A[good], t2n(At)[good]),
        np.broadcast_to(np.eye(n), A[good].shape),
        atol=1e-9 if dtype == np.float64 else 1e-2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_gj_invert_pd_matches_jax(dtype):
    B, n = 6, 6
    M, _ = make_monotone(B, n, 29, dtype)
    M[2] = -M[2]                              # negative definite: pd_ok False
    M[3, 1, 1] = -5.0                         # indefinite
    Aj, okj = jlcp.gj_invert_pd(jnp.asarray(M))
    At, okt = tlcp.gj_invert_pd(torch.tensor(M))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert list(t2n(okt)) == [True, True, False, False, True, True]
    rt = 1e-12 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(t2n(At), np.asarray(Aj), rtol=rt,
                               atol=rt * np.abs(np.asarray(Aj)).max())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """The checks a CUDA tensor meets before a launch, reached here through
    the shared checker (no card needed): device, dtype, shape, contiguity and
    the shared-memory gate."""
    M = torch.zeros(2, 4, 4)
    q = torch.zeros(2, 4)
    mask = torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unsupported device"):
        hopper_lcp._check_inputs("bpp_lcp", M, q, mask, None)
    # the plain route of the wrapper does not count as a launch
    before = hopper_lcp.bpp_lcp.launches
    hopper_lcp.bpp_lcp(M + torch.eye(4), q - 1.0, mask)
    assert hopper_lcp.bpp_lcp.launches == before
    assert set(hopper_lcp.KERNELS) == {"ppm_lcp", "bpp_lcp"}


@pytest.mark.cuda
def test_bpp_kernel_matches_plain_on_the_card():
    """Kernel against plain version on the card (skipped without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU interpreter")
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-10)):
        M, q = make_monotone(64, 66, 3, dtype)
        mask = np.random.default_rng(3).uniform(size=(64, 66)) < 0.8
        mask[0] = False
        Mt, qt, mt = (torch.tensor(x, device="cuda") for x in (M, q, mask))
        before = hopper_lcp.bpp_lcp.launches
        zk, okk = hopper_lcp.bpp_lcp(Mt, qt, mt, max_bpp=12)
        assert hopper_lcp.bpp_lcp.launches == before + 1
        zp, okp = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, max_bpp=12)
        torch.cuda.synchronize()
        assert bool((okk == okp).all()) and bool(okk.all())
        scale = max(1.0, float(zp.abs().max()))
        assert float((zk - zp).abs().max()) <= tol * scale
