"""PyTorch port: `moby_tpu_torch.solvers.lcp` against `moby_tpu.solvers.lcp`.

The same random problems (numpy, seeded) go through the vmapped JAX solver
and the batched port. A pivoting solver must agree on `ok`, on the active set
and on `z` within `_verify`'s tolerance m·‖M‖∞·√eps; on well-conditioned
float64 problems the two follow the same pivots, so z agrees far tighter and
the tests hold it to 1e-9. float32 runs exercise the Gauss–Jordan routes,
where elimination order is the same but matmul summation order is not:
z is held to 2e-3·max(1, ‖z‖∞).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.solvers import lcp as jlcp
from moby_tpu_torch.solvers import lcp as tlcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_kkt, make_monotone, t2n

B = 6


def _problems(kind, n, seed, dtype):
    if kind == "monotone":
        M, q = make_monotone(B, n, seed, dtype)
    else:
        M, q = make_kkt(B, n - n // 3, n // 3, seed, dtype)
    rng = np.random.default_rng(seed + 100)
    mask = np.ones((B, n), bool)
    mask[1, n - 3:] = False                      # partial mask
    mask[2] = rng.uniform(size=n) < 0.6          # scattered mask
    mask[3] = False                              # empty problem
    q[4] = np.abs(q[4]) + 0.1                    # q > 0: trivial
    skip = np.zeros(B, bool)
    skip[5] = True
    z0 = np.zeros((B, n), dtype)
    z0[0, : n // 2] = np.abs(rng.normal(size=n // 2))   # a warm start
    return M, q, mask, z0, skip


def _tol(dtype, z):
    scale = max(1.0, float(np.abs(z).max()))
    return (1e-9 if dtype == np.float64 else 2e-3) * scale


def _verify_np(M, q, z, mask, dtype):
    """`_verify` with tolerance m·‖M‖∞·√eps, in float64 numpy."""
    for b in range(len(q)):
        m = mask[b]
        if not m.any():
            continue
        Mb = M[b][np.ix_(m, m)].astype(np.float64)
        zb = z[b][m].astype(np.float64)
        w = Mb @ zb + q[b][m]
        tol = m.sum() * np.abs(Mb).sum(1).max() * np.sqrt(np.finfo(dtype).eps)
        assert zb.min() >= -tol and w.min() >= -tol
        assert np.abs(zb * w).max() <= tol


SOLVERS = {
    "lcp_bpp": lambda L, M, q, m, z0, s: L.lcp_bpp(M, q, m, z0=z0, skip=s),
    "lcp_fast": lambda L, M, q, m, z0, s: L.lcp_fast(M, q, m, z0=z0, skip=s),
    "lcp_fast_cold": lambda L, M, q, m, z0, s: L.lcp_fast(M, q, m, skip=s),
    "lcp_fast_regularized": lambda L, M, q, m, z0, s: L.lcp_fast_regularized(
        M, q, m, z0=z0, min_exp=-20, step_exp=4, max_exp=-8, skip=s),
    "lcp_lemke": lambda L, M, q, m, z0, s: L.lcp_lemke(M, q, m, skip=s),
    "lcp_lemke_regularized": lambda L, M, q, m, z0, s: L.lcp_lemke_regularized(
        M, q, m, skip=s),
    "solve_lcp": lambda L, M, q, m, z0, s: L.solve_lcp(
        M, q, m, z0=z0, skip=s, **({"device": "cpu"} if L is tlcp else {})),
    "solve_lcp_fast_lemke": lambda L, M, q, m, z0, s: L.solve_lcp_fast_lemke(
        M, q, m, z0=z0, skip=s),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["monotone", "kkt"])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_matches_jax(name, kind, dtype):
    n = 12 if kind == "monotone" else 15
    if dtype == np.float32 and "lemke" in name and name != "solve_lcp_fast_lemke":
        # Lemke's ratio test in float32 may break near-ties differently on a
        # different LU; the float32 cascade test below still covers it
        n = 8
    M, q, mask, z0, skip = _problems(kind, n, 3, dtype)
    fn = SOLVERS[name]
    zj, okj = jax.vmap(lambda M_, q_, m_, z_, s_: fn(jlcp, M_, q_, m_, z_, s_))(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(z0),
        jnp.asarray(skip))
    zt, okt = fn(tlcp, torch.tensor(M), torch.tensor(q), torch.tensor(mask),
                 torch.tensor(z0), torch.tensor(skip))
    zj, okj, zt, okt = np.asarray(zj), np.asarray(okj), t2n(zt), t2n(okt)
    assert zt.dtype == dtype
    np.testing.assert_array_equal(okt, okj)
    assert not okt[5] and np.all(zt[5] == 0)          # skipped member
    tol = _tol(dtype, zj)
    np.testing.assert_allclose(zt, zj, atol=tol, rtol=0)
    np.testing.assert_array_equal(np.abs(zt) > 10 * tol, np.abs(zj) > 10 * tol)
    if name != "lcp_bpp" or kind == "monotone":
        good = okt & ~skip
        _verify_np(M[good], q[good], zt[good], mask[good], dtype)


@pytest.mark.parametrize("blocked", [False, True], ids=["gj", "gj_blocked"])
def test_gj_solve_masked_matches_jax(blocked):
    """The float32 sub-solve routes, on float64 data so that only the
    algorithm is compared: 1e-10."""
    n = 40
    M, q = make_monotone(4, n, 11)
    rng = np.random.default_rng(5)
    nb = rng.uniform(size=(4, n)) < 0.5
    outer = nb[:, :, None] & nb[:, None, :]
    A = np.where(outer, M, 0.0) + np.eye(n) * (~nb)[:, None, :]
    b = np.where(nb, q, 0.0)
    A[3, 7, :] = 0.0
    A[3, :, 7] = 0.0          # a vanishing pivot: skipped, reported by ok
    jf = jlcp.gj_solve_masked_blocked if blocked else jlcp.gj_solve_masked
    tf = tlcp.gj_solve_masked_blocked if blocked else tlcp.gj_solve_masked
    xj, okj = jf(jnp.asarray(A), jnp.asarray(b), jnp.asarray(nb))
    xt, okt = tf(torch.tensor(A), torch.tensor(b), torch.tensor(nb))
    np.testing.assert_array_equal(t2n(okt), np.asarray(okj))
    assert not t2n(okt)[3] and t2n(okt)[:3].all()
    np.testing.assert_allclose(t2n(xt), np.asarray(xj), atol=1e-10, rtol=0)


def test_pad_verify_norm_match_jax():
    M, q, mask, _, _ = _problems("kkt", 15, 9, np.float64)
    Mt, qt, mt = torch.tensor(M), torch.tensor(q), torch.tensor(mask)
    Mp, qp = tlcp.pad_lcp(Mt, qt, mt)
    Mj, qj = jax.vmap(jlcp.pad_lcp)(jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask))
    np.testing.assert_array_equal(t2n(Mp), np.asarray(Mj))
    np.testing.assert_array_equal(t2n(qp), np.asarray(qj))
    nj = jax.vmap(jlcp._masked_norm_inf)(jnp.asarray(M), jnp.asarray(mask))
    np.testing.assert_allclose(t2n(tlcp._masked_norm_inf(Mt, mt)), np.asarray(nj),
                               rtol=1e-14)
    z = np.abs(np.random.default_rng(1).normal(size=q.shape))
    tol = np.full(len(q), 0.5)
    vj = jax.vmap(jlcp._verify)(Mj, qj, jnp.asarray(z), jnp.asarray(mask),
                                jnp.asarray(tol))
    vt = tlcp._verify(Mp, qp, torch.tensor(z), mt, torch.tensor(tol))
    np.testing.assert_array_equal(t2n(vt), np.asarray(vj))


def test_solve_lcp_device_and_cascade_arguments():
    M, q = make_monotone(2, 5, 0)
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mask = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises((ValueError, RuntimeError)):
        tlcp.solve_lcp(Mt, qt, mask)          # default device is the card
    with pytest.raises(ValueError):
        tlcp.solve_lcp(Mt, qt, mask, device="cpu", cascade="fast")
