"""PyTorch port: the launch plan of the two LCP kernels and the pivot
arithmetic of their n > 32 path (`moby_tpu_torch.solvers.hopper_lcp`).

`launch_plan` picks the path from n and the dtype: a group of G lanes per
problem for n <= 32 (G the smallest of 8, 16, 32 that is >= n), one block
per problem above, with today's size gate and shared memory.

`_ppm_tableau_plain` is the block path's pivot loop (a tableau updated by one
principal pivot per entering or leaving index, rebuilt every R updates,
before "done" and after a tiny pivot) in batched PyTorch. It is held against
`ppm_lcp_plain` (a fresh Gauss–Jordan per pivot) and the Pallas kernel in
interpret mode, as the JAX package's own tests run it: the same `done` and
pivot count, and z within 1e-10·max(1, ‖z‖∞) in float64 (the final z comes
from a fresh solve in both, so only the order of sums differs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.solvers import pallas_lcp
from moby_tpu_torch.solvers import hopper_lcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_monotone, t2n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 6, 8, 9, 16, 17, 32, 33, 66, 96, 160])
def test_launch_plan(n, dtype):
    B = 1536
    plan = hopper_lcp.launch_plan(n, dtype, B)
    if n <= 32:
        g = min(w for w in (8, 16, 32) if w >= n)
        assert plan.path == "group" and plan.group == g and plan.smem == 0
        assert plan.per_block == 64 // g
        assert plan.grid == -(-B // plan.per_block)
        assert plan.grid * plan.per_block >= B > (plan.grid - 1) * plan.per_block
    else:
        assert plan.path == "block" and plan.group == 0
        assert (plan.per_block, plan.grid) == (1, B)
        assert plan.smem == hopper_lcp.smem_bytes(n, dtype)
    # the gate and the block's shared memory are those of the one-block design
    np_ = -(-n // 32) * 32
    size = 8 if dtype == torch.float64 else 4
    assert hopper_lcp.smem_bytes(n, dtype) == (2 * np_ * np_ + 4 * np_) * size + 3 * np_ * 4
    assert hopper_lcp.fits(n, dtype) == (n <= (96 if dtype == torch.float64 else 160))


def test_launch_plan_at_the_mpc_shape():
    """B=1536 problems of n=8: 8 a block of two warps, 192 blocks, more than
    the 132 SMs of an H100."""
    plan = hopper_lcp.launch_plan(8, torch.float32, 1536)
    assert (plan.group, plan.per_block, plan.grid) == (8, 8, 192)


def _pallas_ppm(M, q, mask):
    z, ok = jax.vmap(lambda a, b, c: pallas_lcp.ppm_lcp_one(a, b, c, interpret=True))(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask))
    return np.asarray(z), np.asarray(ok)


def _singular(M, q):
    """A zero active row and column whose q wants to enter: its pivot is 0 in
    every tableau, so the loop falls back to the fresh Gauss–Jordan."""
    M, q = M.copy(), q.copy()
    M[:, 2, :] = 0.0
    M[:, :, 2] = 0.0
    q[:, 2] = -1.0
    q[1, 2] = -50.0          # first minimum of q: the cold start pivots on it
    return M, q


@pytest.mark.parametrize("refresh", [16, 1], ids=["R16", "R1"])
@pytest.mark.parametrize("case", ["monotone", "warm", "singular"])
@pytest.mark.parametrize("n", [33, 66])
def test_tableau_pivot_loop_matches_plain_and_pallas(n, case, refresh):
    B = 4
    M, q = make_monotone(B, n, 7 + n)
    if case == "singular":
        M, q = _singular(M, q)
    mask = np.ones((B, n), bool)
    mask[3, n - 5:] = False
    Mt, qt, mt = torch.tensor(M), torch.tensor(q), torch.tensor(mask)
    z0 = None
    if case == "warm":
        # a warm start that is not a solution: a random half of the slots
        z0 = torch.tensor(np.abs(np.random.default_rng(n).normal(size=(B, n))))
        z0[:, ::2] = 0.0
    z, done, piv, stats = hopper_lcp._ppm_tableau_plain(Mt, qt, mt, z0=z0, refresh=refresh)
    zp, dp, pp, _ = hopper_lcp.ppm_lcp_plain(Mt, qt, mt, z0=z0, with_pivots=True)
    np.testing.assert_array_equal(t2n(done), t2n(dp))
    np.testing.assert_array_equal(t2n(piv), t2n(pp))
    assert t2n(done).all()
    tol = 1e-10 * max(1.0, float(zp.abs().max()))
    np.testing.assert_allclose(t2n(z), t2n(zp), atol=tol, rtol=0)
    if z0 is None:
        zj, okj = _pallas_ppm(M, q, mask)
        np.testing.assert_array_equal(t2n(done), okj)
        np.testing.assert_allclose(t2n(z), zj, atol=tol, rtol=0)
    # the tableau was updated by rank-one pivots; with R=1 it is rebuilt on
    # every pivot, with R=16 it is updated more often than rebuilt, and a
    # singular problem meets a tiny pivot in its builds
    assert stats["updates"] > 0
    if refresh == 1:
        assert stats["builds"] == int(piv.sum())
    if case == "singular":
        assert stats["tiny_builds"] > 0
    else:
        assert stats["tiny_builds"] == 0
        if refresh > 1:
            assert stats["updates"] > stats["builds"]


def test_tableau_pivot_loop_nan_and_cap():
    """A NaN in M stalls the pivoting as in `ppm_lcp_plain` (done=0, z=0);
    out of pivots, z is 0 and done=0 in both."""
    B, n = 3, 40
    M, q = make_monotone(B, n, 3)
    q[0] = -np.abs(q[0])
    M[0, 1, 3] = np.nan
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mt = torch.ones(B, n, dtype=torch.bool)
    for max_piv in (None, 2):
        z, done, piv, _ = hopper_lcp._ppm_tableau_plain(Mt, qt, mt, max_piv=max_piv)
        zp, dp, pp, _ = hopper_lcp.ppm_lcp_plain(Mt, qt, mt, max_piv=max_piv,
                                                 with_pivots=True)
        np.testing.assert_array_equal(t2n(done), t2n(dp))
        np.testing.assert_array_equal(t2n(piv), t2n(pp))
        assert not bool(done[0])
        np.testing.assert_allclose(t2n(z), t2n(zp), atol=1e-10, rtol=0)
        assert np.all(t2n(z)[~t2n(done)] == 0)
