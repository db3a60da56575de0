"""PyTorch port: the differentiable LCP (`moby_tpu_torch.solvers.difflcp`)
against `moby_tpu.solvers.difflcp`, float64 on the CPU unless a test says
otherwise; inputs made with numpy from a seed.

Tolerances: the IFT residuals and pullbacks are straight-line code on the
same active set: 1e-9 relative in float64 (`torch.linalg.inv` against
`jnp.linalg.inv`), 1e-4 in float32 (two Gauss–Jordan eliminations in
another summation order). The cascade's z is held to 1e-9·max(1, ‖z‖∞): both
sides reach the same active set and solve the same system with LAPACK.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.solvers import difflcp as jdiff
from moby_tpu.solvers import lcp as jlcp
from moby_tpu_torch.solvers import difflcp as tdiff
from moby_tpu_torch.solvers import hopper_lcp
from moby_tpu_torch.solvers.difflcp import MPCOptions
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_kkt, make_monotone, t2n


def _solved(B, n, seed, dtype=np.float64):
    """Monotone problems, partial masks, and their solutions."""
    M, q = make_monotone(B, n, seed, dtype)
    mask = np.random.default_rng(seed).uniform(size=(B, n)) < 0.8
    mask[0] = True
    z, ok = jax.vmap(lambda M_, q_, m_: jlcp.solve_lcp(M_, q_, m_))(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask))
    assert bool(ok.all())
    return M, q, mask, np.asarray(z)


def _rank_deficient(seed=5):
    """KKT-shaped problems whose active block is singular: two identical
    inequality rows, both active at the solution."""
    M, q = make_kkt(3, 5, 3, seed)
    M[:, 6, :] = M[:, 5, :]
    M[:, :, 6] = M[:, :, 5]
    q[:, 5:7] = -0.5
    mask = np.ones(q.shape, bool)
    z = np.abs(np.random.default_rng(seed).normal(size=q.shape)) + 0.1
    z[:, 7] = 0.0
    return M, q, mask, z


@pytest.mark.parametrize("case", ["solved", "rank_deficient"])
@pytest.mark.parametrize("transpose", [True, False], ids=["T", "N"])
def test_prep_bwd_and_ift_bwd_match_jax(case, transpose):
    M, q, mask, z = _solved(5, 9, 31) if case == "solved" else _rank_deficient()
    zbar = np.random.default_rng(1).normal(size=z.shape)
    act_j, Ainv_j = jax.vmap(
        lambda M_, z_, m_: jdiff._prep_bwd(M_, z_, m_, transpose=transpose)
    )(jnp.asarray(M), jnp.asarray(z), jnp.asarray(mask))
    Mbar_j, qbar_j = jax.vmap(jdiff._ift_bwd)(
        act_j, Ainv_j, jnp.asarray(z), jnp.asarray(zbar))
    act_t, Ainv_t = tdiff._prep_bwd(
        torch.tensor(M), torch.tensor(z), torch.tensor(mask), transpose=transpose)
    Mbar_t, qbar_t = tdiff._ift_bwd(act_t, Ainv_t, torch.tensor(z),
                                    torch.tensor(zbar))
    np.testing.assert_array_equal(t2n(act_t), np.asarray(act_j))
    scale = np.abs(np.asarray(Ainv_j)).max()
    assert np.isfinite(scale) and scale > 0
    np.testing.assert_allclose(t2n(Ainv_t), np.asarray(Ainv_j), rtol=1e-9,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(t2n(qbar_t), np.asarray(qbar_j), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(qbar_j)).max())
    np.testing.assert_allclose(t2n(Mbar_t), np.asarray(Mbar_j), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(Mbar_j)).max())


@pytest.mark.parametrize("n_active,cap", [(10, 16), (40, 16)],
                         ids=["fits_cap", "over_cap_poisons"])
def test_compacted_prep_bwd_matches_jax_float32(n_active, cap, monkeypatch):
    """The NA-compacted inverse (float32, n > max(cap, 48)): the same
    pullback as the JAX package's, and NaN when the active set exceeds the
    cap."""
    monkeypatch.setenv("MOBY_IFT_COMPACT_NA", str(cap))
    rng = np.random.default_rng(0)
    B, n = 2, 64
    G = rng.normal(size=(B, n, n))
    M = (np.einsum("bij,bkj->bik", G, G) + n * np.eye(n)).astype(np.float32)
    mask = rng.uniform(size=(B, n)) < 0.9
    z = np.where(rng.uniform(size=(B, n)) < n_active / n,
                 rng.uniform(size=(B, n)) + 0.1, 0.0).astype(np.float32)
    z = np.where(mask, z, 0.0).astype(np.float32)
    zbar = rng.normal(size=(B, n)).astype(np.float32)
    act_j, res_j = jax.vmap(jdiff._prep_bwd)(
        jnp.asarray(M), jnp.asarray(z), jnp.asarray(mask))
    assert isinstance(res_j, tuple)
    _, qbar_j = jax.vmap(jdiff._ift_bwd)(act_j, res_j, jnp.asarray(z),
                                         jnp.asarray(zbar))
    opts = MPCOptions(ift_compact_na=cap)
    act_t, res_t = tdiff._prep_bwd(torch.tensor(M), torch.tensor(z),
                                   torch.tensor(mask), options=opts)
    assert isinstance(res_t, tuple)
    _, qbar_t = tdiff._ift_bwd(act_t, res_t, torch.tensor(z), torch.tensor(zbar))
    np.testing.assert_array_equal(t2n(act_t), np.asarray(act_j))
    if n_active > cap:
        assert np.all(np.isnan(t2n(qbar_t)[t2n(act_t)]))
        assert np.all(np.isnan(np.asarray(qbar_j)[np.asarray(act_j)]))
    else:
        np.testing.assert_allclose(
            t2n(qbar_t), np.asarray(qbar_j), rtol=1e-4,
            atol=1e-4 * np.abs(np.asarray(qbar_j)).max())
    assert tdiff._compact_cap(48, opts) == 0 and tdiff._compact_cap(64, opts) == cap
    assert tdiff._compact_cap(64) == 32 and tdiff._compact_cap(40) == 0


def _jax_vjp(fn, M, q, zbar, *rest):
    def one(M_, q_, zb_, *r_):
        z, pull = jax.vjp(lambda a, b: fn(a, b, *r_), M_, q_)
        return (z,) + pull(zb_)
    return jax.vmap(one)(jnp.asarray(M), jnp.asarray(q), jnp.asarray(zbar),
                         *(jnp.asarray(r) for r in rest))


@pytest.mark.parametrize("which", ["diff_mpc", "given", "diff", "given_rank_deficient"])
def test_gradients_match_jax_vjp(which):
    if which == "given_rank_deficient":
        M, q, mask, z = _rank_deficient()
    else:
        M, q, mask, z = _solved(4, 8, 41)
    B, n = q.shape
    zbar = np.random.default_rng(2).normal(size=(B, n))
    z0 = np.zeros((B, n))
    skip = np.zeros(B, bool)
    Mt = torch.tensor(M, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    mt = torch.tensor(mask)
    if which == "diff_mpc":
        zj, Mbar_j, qbar_j = _jax_vjp(jdiff.solve_lcp_diff_mpc, M, q, zbar,
                                      mask, z0, skip)
        zt = tdiff.solve_lcp_diff_mpc(Mt, qt, mt, torch.tensor(z0),
                                      torch.tensor(skip))
    elif which == "diff":
        zj, Mbar_j, qbar_j = _jax_vjp(jdiff.solve_lcp_diff, M, q, zbar, mask, z0)
        zt = tdiff.solve_lcp_diff(Mt, qt, mt, torch.tensor(z0), device="cpu")
    else:
        zj, Mbar_j, qbar_j = _jax_vjp(jdiff.solve_lcp_given, M, q, zbar, mask, z)
        zt = tdiff.solve_lcp_given(Mt, qt, mt, torch.tensor(z))
    Mbar_t, qbar_t = torch.autograd.grad(zt, (Mt, qt), torch.tensor(zbar))
    np.testing.assert_allclose(t2n(zt), np.asarray(zj), rtol=0,
                               atol=1e-9 * max(1.0, np.abs(np.asarray(zj)).max()))
    for got, want in ((Mbar_t, Mbar_j), (qbar_t, qbar_j)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(t2n(got), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_no_inverse_without_a_gradient_and_none_to_z0(monkeypatch):
    """The inverse is computed in the forward only when M or q requires a
    gradient; z0, mask and skip get none."""
    M, q, mask, z = _solved(3, 6, 43)
    calls = []
    real = tdiff._prep_bwd
    monkeypatch.setattr(tdiff, "_prep_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    Mt, qt, mt = torch.tensor(M), torch.tensor(q), torch.tensor(mask)
    tdiff.solve_lcp_diff_mpc(Mt, qt, mt)
    tdiff.solve_lcp_given(Mt, qt, mt, torch.tensor(z))
    assert not calls
    z0 = torch.zeros_like(qt, requires_grad=True)
    qg = qt.clone().requires_grad_(True)
    out = tdiff.solve_lcp_diff_mpc(Mt, qg, mt, z0)
    assert len(calls) == 1
    g = torch.autograd.grad(out.sum(), (qg, z0), allow_unused=True)
    assert g[0] is not None and g[1] is None


# ------------------------------------------------------------- the cascade
def _cascade_problems():
    """One problem per way out of the cascade (n=4, padded by an inactive
    slot): 0 leaves at stage 1 (monotone); 1 at the first regularized stage
    that has a λ above rounding (M singular on the cold start set, so the
    unregularized float64 sub-solve is not finite); 2 is skipped; 3 is
    poisoned (NaN in q fails every stage's check); 4 has an empty mask."""
    rng = np.random.default_rng(3)
    B, n = 5, 4
    A = rng.normal(size=(B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n))
    q[0, 0] = -1.0
    mask = np.ones((B, n), bool)
    mask[:, 3] = False
    M[1] = 0.0
    M[1, :2, :2] = 1.0
    M[1, 2, 2] = 1.0
    q[1] = [-1.0, -0.5, 1.0, 0.0]
    q[3, 1] = np.nan
    mask[4] = False
    skip = np.zeros(B, bool)
    skip[2] = True
    return M, q, mask, skip


def _run_cascade(M, q, mask, skip, options, z0=None):
    """-> z, ok, {stage: indices of the problems that left the cascade
    there}, read from outside: every solver call of the cascade is told which
    problems to leave alone (its `skip`, or an emptied mask on the kernel
    route), so a problem left at the stage after which it is first left
    alone. "skipped" is what the first call left alone, "poisoned" the rows
    of NaN."""
    from moby_tpu_torch.solvers import lcp as tlcp

    closed = []

    def spy(mod, name, closed_of):
        real = getattr(mod, name)

        def call(*a, **k):
            closed.append(t2n(closed_of(a, k)))
            return real(*a, **k)
        return mock.patch.object(mod, name, call)

    def by_skip(a, k):
        return k["skip"]

    def by_mask(a, k):
        return ~a[2].any(dim=1)

    with spy(tlcp, "lcp_bpp", by_skip), \
            spy(tlcp, "lcp_fast_regularized", by_skip), \
            spy(hopper_lcp, "bpp_lcp", by_mask), \
            spy(hopper_lcp, "ppm_lcp", by_mask):
        z, ok = tdiff._mpc_forward(
            torch.tensor(M), torch.tensor(q), torch.tensor(mask),
            None if z0 is None else torch.tensor(z0), torch.tensor(skip),
            options)
    z, ok = t2n(z), t2n(ok)
    names = (["stage1"] + ["ppm_rescue"] * options.ppm_rescue
             + ["stage2"] * options.stage2 + ["ladder"] * len(options.ladder)
             + ["rescue"] * options.rescue)
    assert len(closed) == len(names)
    closed.append(closed[0] | ok)
    left = {s: [] for s in ("stage1", "ppm_rescue", "stage2", "ladder", "rescue")}
    for i, name in enumerate(names):
        left[name] += np.nonzero(closed[i + 1] & ~closed[i])[0].tolist()
    left["skipped"] = np.nonzero(closed[0])[0].tolist()
    left["poisoned"] = np.nonzero(np.isnan(z).all(axis=1))[0].tolist()
    return z, ok, left


def _jax_cascade(M, q, mask, skip, z0=None):
    z0 = np.zeros_like(q) if z0 is None else z0
    return jax.vmap(jdiff._mpc_xla)(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(z0),
        jnp.asarray(skip))


CASCADE_OPTIONS = {
    # where problem 1 leaves, the port's options, the JAX package's knobs
    "stage2": (MPCOptions(), {}),
    "ladder": (MPCOptions(lam_scale=1e-12, ladder=(1e13, 1e15)),
               {"MOBY_MPC_LAM_SCALE": "1e-12", "MOBY_MPC_LADDER": "1e13,1e15"}),
    "rescue": (MPCOptions(stage2=False, ladder=()),
               {"MOBY_MPC_STAGE2": "0", "MOBY_MPC_LADDER": ""}),
    "poisoned": (MPCOptions(stage2=False, ladder=(), rescue=False),
                 {"MOBY_MPC_STAGE2": "0", "MOBY_MPC_LADDER": "",
                  "MOBY_MPC_RESCUE": "0"}),
}


@pytest.mark.parametrize("route", ["plain", "accel"])
@pytest.mark.parametrize("leaves_at", sorted(CASCADE_OPTIONS))
def test_mpc_forward_stage_by_stage_matches_mpc_xla(leaves_at, route, monkeypatch):
    """`_mpc_forward` against `_mpc_xla` with the same options, and the
    port's own account of where each problem left. route="accel" forces the
    kernel route on the CPU, so `bpp_lcp_plain` stands in for the kernel:
    its sub-solves skip a vanishing pivot instead of failing, so it may solve
    at stage 1 what the batched float64 route passes on; the result still
    has to be the same solution of the same problem."""
    options, env = CASCADE_OPTIONS[leaves_at]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    M, q, mask, skip = _cascade_problems()
    zj, okj = _jax_cascade(M, q, mask, skip)
    opts = MPCOptions(**{**options.__dict__, "cascade": route})
    before = hopper_lcp.bpp_lcp.launches
    zt, okt, left = _run_cascade(M, q, mask, skip, opts)
    assert hopper_lcp.bpp_lcp.launches == before      # no kernel on the CPU
    zj, okj = np.asarray(zj), np.asarray(okj)
    expect_ok = [True, leaves_at != "poisoned", False, False, True]
    assert list(okj) == expect_ok
    assert np.all(np.isnan(zj[3])) and np.all(zj[2] == 0)
    if route == "plain":
        np.testing.assert_array_equal(okt, okj)
        np.testing.assert_array_equal(np.isnan(zt), np.isnan(zj))
        fin = np.isfinite(zj)
        np.testing.assert_allclose(zt[fin], zj[fin], rtol=0, atol=1e-9)
        want = {"skipped": [2], "stage1": [0, 4], "stage2": [], "ladder": [],
                "rescue": [], "ppm_rescue": [], "poisoned": [3]}
        want[leaves_at] = sorted(want[leaves_at] + [1])
        assert left == want
    else:
        # problem 1's z: (1, 0, 0) up to the λ of the stage that solved it
        assert list(okt[[0, 2, 3, 4]]) == [True, False, False, True]
        assert np.all(np.isnan(zt[3])) and np.all(zt[2] == 0)
        np.testing.assert_allclose(zt[0], zj[0], rtol=0, atol=1e-9)
        assert okt[1]
        np.testing.assert_allclose(zt[1, 0] + zt[1, 1], 1.0, atol=1e-6)
        # the empty mask of problem 4 is left alone from the first call on
        assert left["skipped"] == [2, 4] and left["poisoned"] == [3]
        assert 0 in left["stage1"]


def test_mpc_forward_warm_start_and_ppm_rescue_match_jax(monkeypatch):
    """Warm-started cascade on monotone and KKT-shaped problems, and the
    optional PPM rescue between stage 1 and stage 2 (JAX: MOBY_MPC_PALLAS=1,
    the Pallas kernel in interpret mode; the port: `ppm_lcp`'s plain
    version), with stage 1 cut to one iteration so that the rescue has work."""
    B, n = 6, 10
    M, q = make_monotone(B, n, 51)
    Mk, qk = make_kkt(2, 7, 3, 51)
    M[4:], q[4:] = Mk, qk
    mask = np.ones((B, n), bool)
    mask[1, 7:] = False
    skip = np.zeros(B, bool)
    zc, okc = _jax_cascade(M, q, mask, skip)
    assert bool(okc.all())
    z0 = np.asarray(zc) * np.random.default_rng(5).uniform(0.5, 1.5, size=(B, n))
    zj, okj = _jax_cascade(M, q, mask, skip, z0)
    zt, okt, left = _run_cascade(M, q, mask, skip, MPCOptions(), z0)
    np.testing.assert_array_equal(okt, np.asarray(okj))
    np.testing.assert_allclose(zt, np.asarray(zj), rtol=0, atol=1e-9)
    assert left["stage1"] == list(range(B))

    monkeypatch.setenv("MOBY_MPC_PALLAS", "1")
    monkeypatch.setenv("MOBY_MPC_BPP_ITERS", "1")
    zj, okj = _jax_cascade(M, q, mask, skip)
    opts = MPCOptions(ppm_rescue=True, bpp_iters=1)
    zt, okt, left = _run_cascade(M, q, mask, skip, opts)
    np.testing.assert_array_equal(okt, np.asarray(okj))
    assert okt.all()
    np.testing.assert_allclose(zt, np.asarray(zj), rtol=0, atol=1e-9)
    assert left["ppm_rescue"]
    assert sorted(left["stage1"] + left["ppm_rescue"]) == list(range(B))


def test_options_defaults_are_the_jax_packages():
    o = MPCOptions()
    assert (o.ift_compact_na, o.bpp_iters, o.ppm_rescue, o.lam_scale, o.stage2,
            o.ladder, o.rescue, o.line_search_steps, o.cascade) == (
        32, 12, False, 10.0, True, (30.0, 1000.0), True, 8, None)
    with pytest.raises(Exception):
        o.bpp_iters = 3          # frozen
    with pytest.raises(ValueError, match="cascade"):
        tdiff._mpc_forward(torch.eye(2)[None], -torch.ones(1, 2),
                           torch.ones(1, 2, dtype=torch.bool), None, None,
                           MPCOptions(cascade="fast"))
