"""PyTorch port: the MPC linearization options — `difflcp.solve_lcp_given_fwd`
(the replay's forward-mode rule), forward-mode step Jacobians (`ilqr.jacfwd`
through `f_replay`, and the block-sparse linearizer `f_replay.jac`), the hoisted
linearization and the bfloat16 Riccati form of `ilqr.ilqr_batched` —
against the JAX package and against the port's reverse mode, float64 on the
CPU.

Tolerances: JVPs and Jacobians 1e-10 (absolute, on entries of order 1) where
the LCP's active block is well conditioned (random LCPs, ball-push, the
block standing on one corner). On the block resting flat (and on one edge),
coplanar contacts make the active block of block-push's n=64 LCP singular
to working precision; the Tikhonov-regularized inverse then amplifies
rounding by up to 1/λ with λ = sqrt(eps)·‖M‖∞, so that derivatives are
determined to about sqrt(eps) relative only: the JAX package's own jacfwd,
jacrev and f_jac of that step differ from each other by 2-3e-9, the port's
from the JAX package's by up to 3e-8 (entries up to 3). There every form is
held within 4·sqrt(eps)·max|A| (2.2e-7 on these states).
Hoisted against unhoisted solves 1e-12 (the same Jacobians, batched
differently). Forward-mode against reverse-mode solves: their Jacobians
agree to 1e-15 along the trajectories, which three iterations amplify to
about 3e-8 of the controls' scale and 1.2e-9 of one member's cost (the
pushing force's direction into the plane hardly moves the cost, so its gain
is large); cost 1e-8 relative, controls and states 1e-6 relative. The bfloat16 Riccati form against the
JAX package's 1e-6 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from moby_tpu.mpc import contact_mpc as jmpc
from moby_tpu.solvers import difflcp as jdl
from moby_tpu.solvers import lcp as jlcp
from moby_tpu_torch.mpc import contact_mpc as tmpc
from moby_tpu_torch.mpc import ilqr as tilqr
from moby_tpu_torch.mpc import MPCOptions
from moby_tpu_torch.solvers import difflcp as tdl
from moby_tpu_torch.solvers import lcp as tlcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (ballpush_both, ballpush_costs, blockpush_both,
                                ilqr_arrays, make_kkt, t2n)

DT = 0.02


# ------------------------------------------------------------------- the JVP
def _kkt_case(B, nv, ni, seed):
    M, q = make_kkt(B, nv, ni, seed)
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mask = torch.ones(qt.shape, dtype=torch.bool)
    z, ok = tlcp.solve_lcp(Mt, qt, mask, device="cpu")
    assert bool(ok.all())
    rng = np.random.default_rng(seed + 1)
    return Mt, qt, mask, z, torch.tensor(rng.normal(size=M.shape)), \
        torch.tensor(rng.normal(size=q.shape)), torch.tensor(rng.normal(size=q.shape))


def _port_jvp(M, q, mask, z, dM, dq):
    with fwAD.dual_level():
        out = tdl.solve_lcp_given_fwd(fwAD.make_dual(M, dM), fwAD.make_dual(q, dq),
                                      mask, z)
        primal, tangent = fwAD.unpack_dual(out)
    assert torch.equal(primal, z)
    return tangent


def _jax_jvp(M, q, mask, z, dM, dq):
    outs = []
    for b in range(M.shape[0]):
        zb, mb = jnp.asarray(t2n(z[b])), jnp.asarray(t2n(mask[b]))
        _, t = jax.jvp(lambda M_, q_: jdl.solve_lcp_given_fwd(M_, q_, mb, zb),
                       (jnp.asarray(t2n(M[b])), jnp.asarray(t2n(q[b]))),
                       (jnp.asarray(t2n(dM[b])), jnp.asarray(t2n(dq[b]))))
        outs.append(np.asarray(t))
    return np.stack(outs)


def _adjoint_gap(M, q, mask, z, dM, dq, v, tangent):
    """|<v, J t> - <Jᵀ v, t>| per problem, with Jᵀ v from the port's VJP."""
    Mr, qr = M.clone().requires_grad_(True), q.clone().requires_grad_(True)
    zz = tdl.solve_lcp_given(Mr, qr, mask, z)
    gM, gq = torch.autograd.grad((zz * v).sum(), (Mr, qr))
    lhs = (v * tangent).sum(dim=1)
    rhs = (gM * dM).sum(dim=(1, 2)) + (gq * dq).sum(dim=1)
    return float((lhs - rhs).abs().max()), float(lhs.abs().max())


@pytest.mark.parametrize("form", ["full", "compacted"])
def test_jvp_matches_jax_and_the_port_vjp(form, monkeypatch):
    if form == "full":
        M, q, mask, z, dM, dq, v = _kkt_case(4, 6, 8, 0)           # n = 14
    else:
        # n = 64 > max(32, 48): the compacted inverse, forced on float64 on
        # both sides (it is the float32 route)
        M, q, mask, z, dM, dq, v = _kkt_case(3, 10, 54, 3)
        monkeypatch.setattr(tlcp, "_use_gj", lambda dtype: True)
        monkeypatch.setattr(jlcp, "_GJ_OVERRIDE", True)
        n_act = int((z > 1e-10).sum(dim=1).max())
        assert 0 < n_act <= 32
        assert tdl._compact_cap(64) == 32
        _, res = tdl._prep_bwd(M, z, mask, transpose=False)
        assert isinstance(res, tuple)
    assert bool((z > 1e-10).any(dim=1).all())
    t = _port_jvp(M, q, mask, z, dM, dq)
    want = _jax_jvp(M, q, mask, z, dM, dq)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(t2n(t), want, rtol=0, atol=1e-10)
    gap, scale = _adjoint_gap(M, q, mask, z, dM, dq, v, t)
    assert gap <= 1e-10 * max(1.0, scale), (gap, scale)


# -------------------------------------------------------------- the Jacobians
def _ball_states():
    jscene, jstate, _, tscene, tstate, _, _ = ballpush_both(1)
    rng = np.random.default_rng(0)
    x = np.repeat(t2n(tmpc.pack(tscene, tstate)), 4, axis=0)
    x[:, 7:13] += rng.normal(size=(4, 6)) * 0.3
    x[:, 2] -= 1e-3                      # pressed into the plane: in contact
    x[:, 9] = -0.05
    u = rng.normal(size=(4, 6)) * 2.0
    u[:, 2] = -np.abs(u[:, 2])
    u[0, 2] = -20.0                      # pressed down
    return {"ball": (jscene, jstate, tscene, tstate, x, u)}


def _block_states():
    """The block resting flat (four coplanar contacts) and standing on one
    corner (rolled, pitched and turned by 0.3, 0.2 and 0.1 rad), with random
    velocities and pushes."""
    from moby_tpu_torch.math import quaternion as tquat

    jscene, jstate, tscene, tstate = blockpush_both()
    rng = np.random.default_rng(1)
    out = {}
    for name in ("block_flat", "block_corner"):
        x = np.repeat(t2n(tmpc.pack(tscene, tstate)), 3, axis=0)
        x[:, 7:13] += rng.normal(size=(3, 6)) * 0.3
        x[:, 9] = -0.3                   # falling onto the plane
        if name == "block_corner":
            q = tquat.from_rpy(torch.tensor([[0.3, 0.2, 0.1]], dtype=torch.float64))
            corners = torch.tensor(np.array(np.meshgrid(*[[-0.2, 0.2]] * 3)).reshape(3, -1).T)
            low = float((corners @ tquat.to_matrix(q)[0].T)[:, 2].min())
            x[:, 3:7] = t2n(q)
            x[:, 2] = -low
        x[:, 2] -= 1e-4
        u = rng.normal(size=(3, 6)) * 2.0
        u[:, 2] = -np.abs(u[:, 2])
        out[name] = (jscene, jstate, tscene, tstate, x, u)
    return out


# where the active block is well conditioned every form of the derivative
# agrees to rounding; on the flat block see the module docstring (None: the
# bound sqrt(eps)-relative rounding gives there)
TOL = {"ball": 1e-10, "block_corner": 1e-10, "block_flat": None}


def _jax_reference(cases):
    """The JAX package's recorded z and block linearizer (`f_replay.jac`) on
    every case of one scene, in one compiled call."""
    jscene, jstate = cases[0][:2]
    jf, jrec, jrep = jmpc.make_dynamics_rr(jscene, jstate, DT)

    def one(x_, u_):
        _, z, _ = jrec(x_, u_, jrec.aux_init())
        return z, jrep.jac(x_, u_, z)

    x = np.concatenate([c[4] for c in cases])
    u = np.concatenate([c[5] for c in cases])
    z, (A, Bm) = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(u))
    out, o = [], 0
    for c in cases:
        k = len(c[4])
        out.append((np.asarray(z)[o:o + k], np.asarray(A)[o:o + k],
                    np.asarray(Bm)[o:o + k]))
        o += k
    return out


@pytest.fixture(scope="module")
def jac_cases():
    out = {}
    for group in (_ball_states(), _block_states()):
        names = list(group)
        for name, ref in zip(names, _jax_reference([group[n] for n in names])):
            out[name] = group[name][2:] + ref
    return out


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, ("A", "B")):
        g, w = t2n(g), t2n(w) if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape and np.isfinite(g).all(), (what, name)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {name}: {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("name", list(TOL))
def test_forward_mode_jacobians_match_jax_and_reverse_mode(name, jac_cases):
    tscene, tstate, x, u, z, A, Bm = jac_cases[name]
    tol = TOL[name] or 4.0 * np.finfo(np.float64).eps ** 0.5 * np.abs(A).max()
    f, f_rec, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT)
    xt, ut = torch.tensor(x), torch.tensor(u)
    _, zt, _ = f_rec(xt, ut, f_rec.aux_init(len(x)))
    np.testing.assert_allclose(t2n(zt), z, rtol=0, atol=1e-10)
    assert bool((zt.abs() > 1e-10).any(dim=1).all())      # every case in contact
    rev = tilqr._jacobians(f_rep, xt, ut, zt)
    fwd = tilqr._jacobians_fwd(f_rep, xt, ut, zt)
    blk = f_rep.jac(xt, ut, zt)
    for got, what in ((blk, "block linearizer"), (fwd, "forward mode"),
                      (rev, "reverse mode")):
        _close(got, (A, Bm), tol, f"{name}: {what} against the JAX f_jac")
    _close(fwd, rev, tol, f"{name}: forward against reverse mode")
    _close(blk, rev, tol, f"{name}: block linearizer against reverse mode")
    # contact shapes the Jacobian: the spin reaches the linear velocity
    assert np.abs(A[:, 7:9, 10:13]).max() > 1e-4


def test_block_linearizer_is_optional():
    jscene, jstate, tscene, tstate = blockpush_both()
    _, _, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT,
                                        MPCOptions(block_jac=False))
    assert getattr(f_rep, "jac", None) is None
    _, _, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT)
    assert callable(f_rep.jac)


def test_jacfwd_of_an_output_no_tangent_reaches():
    x = torch.randn(3, 2, dtype=torch.float64)
    u = torch.randn(3, 1, dtype=torch.float64)
    outs, jacs = tilqr.jacfwd(lambda x_, u_: (x_ * u_, torch.ones_like(x_)),
                              (x, u), (0, 1))
    assert torch.equal(outs[0], x * u)
    assert torch.equal(jacs[0][0], torch.diag_embed(u.expand(3, 2)))
    assert torch.equal(jacs[0][1], x[:, :, None])
    assert not jacs[1][0].any() and not jacs[1][1].any()


# ------------------------------------------------ hoisted, forward-mode, bf16
B, H, ITERS = 4, 12, 3


@pytest.fixture(scope="module")
def ball_task():
    jscene, jstate, jb, tscene, tstate, tb, _ = ballpush_both(B, seed=0)
    jcost, jfinal, tcost, tfinal = ballpush_costs()
    tprob = tmpc.MPCProblem(scene=tscene, template=tstate, dt=DT, horizon=H)
    jprob = jmpc.MPCProblem(scene=jscene, template=jstate, dt=DT, horizon=H)

    memo = {}

    def solve(**kw):
        """The solve with these keywords (each distinct one computed once)."""
        key = repr(sorted(kw.items()))
        if key not in memo:
            memo[key] = ilqr_arrays(tmpc.solve_batch(tprob, tb, tcost, tfinal,
                                                     device="cpu", **kw))
        return memo[key]

    return solve, jprob, jb, jcost, jfinal


def _same(got, want, tol, what):
    for g, w, name in zip(got, want, ("us", "xs", "cost")):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("record_replay", [True, False])
def test_hoisted_equals_unhoisted(record_replay, ball_task):
    solve = ball_task[0]
    want = solve(n_iters=ITERS, record_replay=record_replay)
    assert np.isfinite(want[2]).all() and want[2].max() < 10.0
    got = solve(n_iters=ITERS, record_replay=record_replay, hoist_linearization=True)
    _same(got, want, 1e-12, f"hoisted, record_replay={record_replay}")


def test_hoist_chunks_do_not_change_values(ball_task):
    """ilqr_batched over chunks of 1, 5 and 12 time steps."""
    jscene, jstate, jb, tscene, tstate, tb, _ = ballpush_both(2, seed=3)
    _, _, tcost, tfinal = ballpush_costs()
    f, f_rec, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT)
    x0s = tmpc.pack(tscene, tb)
    us0 = torch.zeros(H, 6, dtype=torch.float64)
    outs = [ilqr_arrays(tilqr.ilqr_batched(
        f, tcost, tfinal, x0s, us0, n_iters=2, f_record=f_rec, f_replay=f_rep,
        hoist_linearization=True, hoist_chunks=c)) for c in (1, 3, 12)]
    for o in outs[1:]:
        _same(o, outs[0], 1e-12, "hoist chunks")


def test_hoist_chunk_model():
    """The chunk count follows from the sizes: one chunk for small batches,
    more as B·H grows past the memory budget, never more than H."""
    _, _, tscene, _ = blockpush_both(torch.float32)
    one = tmpc.hoist_chunks(tscene, 1024, 30, torch.float32)
    big = tmpc.hoist_chunks(tscene, 8192, 30, torch.float32)
    huge = tmpc.hoist_chunks(tscene, 10 ** 7, 30, torch.float32)
    assert one == 1 and 1 < big < 30 and huge == 30
    n = tscene.n_lcp
    per_step = 8192 * 13 * 4 * (tmpc.REPLICA_MATRICES * n * n + tmpc.REPLICA_SCALARS)
    assert -(-30 // (tmpc.HOIST_BUDGET_BYTES // per_step)) == big
    # forward mode replicates over x and u; float64 doubles the bytes
    assert tmpc.hoist_chunks(tscene, 8192, 30, torch.float32, linearize_fwd=True,
                             options=MPCOptions(block_jac=False)) > big
    assert tmpc.hoist_chunks(tscene, 8192, 30, torch.float64) > big


@pytest.mark.parametrize("block_jac", [True, False])
def test_forward_linearization_equals_reverse(block_jac, ball_task):
    solve = ball_task[0]
    want = solve(n_iters=ITERS, record_replay=True)
    for hoist in ((False, True) if block_jac else (False,)):
        got = solve(n_iters=ITERS, linearize_fwd=True, hoist_linearization=hoist,
                    options=MPCOptions(block_jac=block_jac))
        what = f"linearize_fwd, block_jac={block_jac}, hoist={hoist}"
        np.testing.assert_allclose(got[2], want[2], rtol=1e-8, atol=0, err_msg=what)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=what)


def test_linearize_fwd_needs_replay(ball_task):
    """Without record/replay solve_batch switches it off, as the JAX package
    does; ilqr_batched itself refuses it."""
    solve = ball_task[0]
    a = solve(n_iters=1, record_replay=False, linearize_fwd=True)
    b = solve(n_iters=1, record_replay=False)
    _same(a, b, 0.0, "linearize_fwd without replay")
    with pytest.raises(ValueError):
        tilqr.ilqr_batched(lambda x, u: x, lambda x, u: x.sum(1), lambda x: x.sum(1),
                           torch.zeros(1, 2), torch.zeros(3, 1), linearize_fwd=True)


def test_riccati_bf16_matches_jax(ball_task, monkeypatch):
    solve, jprob, jb, jcost, jfinal = ball_task
    monkeypatch.setenv("MOBY_MPC_RICCATI_BF16", "1")
    want = ilqr_arrays(jmpc.solve_batch(jprob, jb, jcost, jfinal, n_iters=2))
    got = solve(n_iters=2, options=MPCOptions(riccati_bf16=True))
    full = solve(n_iters=2)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-6 * np.abs(want[0]).max())
    # the rounding really happened, and the solve still descends
    assert np.abs(got[0] - full[0]).max() > 0
    assert (got[2] <= want[2] * (1 + 1e-6)).all() and np.isfinite(got[2]).all()
