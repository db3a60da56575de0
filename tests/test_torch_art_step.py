"""PyTorch port: the articulated step — pose table, joint-space inverse
inertia, joint-limit rows, the no-slip impact model and whole-step
trajectories — against `moby_tpu`, float64 on the CPU unless a test says
otherwise.

Inputs are made with numpy from a seed. Straight-line code is held to 1e-10,
trajectories to L∞ <= 1e-9 over the whole rollout (measured ~1e-14). The
no-slip LCP of the table is redundant (8 coplanar vertex slots per box,
four coplanar legs), so its z is not unique: the velocity change it causes
is held to 1e-9, the impulses to `lcp._verify`'s tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu import config as jcfg
from moby_tpu.core import scene as jsc
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.sim import impact as jimp
from moby_tpu.sim import kinematics as jkin
from moby_tpu.sim import noslip as jns
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch import config as tcfg
from moby_tpu_torch.dynamics import aba
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.sim import impact as timp
from moby_tpu_torch.sim import kinematics as tkin
from moby_tpu_torch.sim import noslip as tns
from moby_tpu_torch.sim import stepper as tstep
from moby_tpu_torch.solvers import hopper_lcp, lcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    batch_jax_art_state, batch_torch_art_state, build_limited_pendulum,
    build_noslip_ball, build_pendulum_ball, build_swing, load_table_both, t2n,
    torch_scene_state,
)

TOL = 1e-10
TRAJ_TOL = 1e-9


def _table_states(B, seed):
    """B table scenarios: the scene's own pose, ω_z drawn in [0.9, 1.1] and
    the base falling at g·1 ms (the state the first mini-step's velocity
    update hands the impact model)."""
    jscene, jstate, tscene, tstate = load_table_both()
    rng = np.random.default_rng(seed)
    q = np.broadcast_to(np.asarray(jstate.q_art), (B, 7)).copy()
    qd = np.zeros((B, 6))
    qd[:, 2] = rng.uniform(0.9, 1.1, size=B)
    qd[:, 5] = -9.81e-3
    return (jscene, batch_jax_art_state(jstate, B, q, qd),
            tscene, batch_torch_art_state(tstate, B, q, qd))


def _jax_batched(fn, *args):
    return jax.jit(jax.vmap(fn))(*args)


def test_art_pose_table_matches_jax():
    """Link poses, quaternions (`from_matrix` per link), velocities and the
    batched W rows of the table and of the pendulum with a free ball, at
    perturbed joint coordinates."""
    jscene, js, tscene, ts = _table_states(3, 0)
    rng = np.random.default_rng(1)
    q = np.asarray(js.q_art) + rng.normal(size=(3, 7)) * 0.1
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = rng.normal(size=(3, 6))
    js = js.replace(q_art=jnp.asarray(q), qd_art=jnp.asarray(qd))
    ts = ts.replace(q_art=torch.tensor(q), qd_art=torch.tensor(qd))
    jb, jst = build_pendulum_ball(jsc).compile()
    tb, tst = torch_scene_state(jb, jst)
    for (jsn, jstate, tsn, tstate) in ((jscene, js, tscene, ts),
                                       (jb, jax.tree_util.tree_map(lambda x: x[None], jst),
                                        tb, tst)):
        jp = _jax_batched(lambda s: jkin.compute(jsn, s), jstate)
        tp = tkin.compute(tsn, tstate)
        assert tp.W.shape == (tstate.batch, tsn.n_pose_slots, 6, tsn.ngc)
        for k in ("pos", "quat", "vel", "omega", "W"):
            np.testing.assert_allclose(t2n(getattr(tp, k)), np.asarray(getattr(jp, k)),
                                       rtol=0, atol=TOL, err_msg=k)
        np.testing.assert_allclose(
            t2n(tkin.gc_velocity(tsn, tstate)),
            np.asarray(jax.vmap(lambda s: jkin.gc_velocity(jsn, s))(jstate)),
            rtol=0, atol=0)


def test_gc_inv_inertia_both_dtypes():
    """float64: LAPACK's inverse, equal to the JAX package's; float32 (the
    card's dtype): the Gauss–Jordan `gj_invert_pd`, equal to
    `torch.linalg.inv` of the same float32 H at float32 tolerance."""
    jscene, js, tscene, ts = _table_states(4, 2)
    rng = np.random.default_rng(3)
    q = np.asarray(js.q_art).copy()
    q[:, 3:7] = rng.normal(size=(4, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    js = js.replace(q_art=jnp.asarray(q))
    ts = ts.replace(q_art=torch.tensor(q))
    ref = _jax_batched(lambda s: jimp.gc_inv_inertia(jscene, s, s.quat), js)
    out = timp.gc_inv_inertia(tscene, ts, ts.quat)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=0, atol=TOL)

    s32, st32 = torch_scene_state(
        jscene, jax.tree_util.tree_map(lambda x: x[0], js), torch.float32)
    st32 = st32.expand(4).replace(q_art=torch.tensor(q, dtype=torch.float32))
    Minv32 = timp.gc_inv_inertia(s32, st32, st32.quat)
    assert Minv32.dtype == torch.float32
    H = aba.crb(s32.arts[0].model, st32.q_art)
    lapack = torch.linalg.inv(H)
    g = s32.arts[0].gc_off
    blk = Minv32[:, g:, g:]
    scale = float(lapack.abs().max())
    assert float((blk - lapack).abs().max()) <= 1e-4 * scale
    assert float((blk - out[:, g:, g:].float()).abs().max()) <= 1e-4 * scale


def test_limit_rows_in_assemble_problem():
    """The limited pendulum past its limits: below the lower stop moving in,
    above the upper one moving in, below the lower one moving out (active
    but not impacting, so not solved): activity, constraint velocity, the
    signed limit rows Jl of the stacked Jacobian, the Delassus A and bv."""
    jscene, jstate = build_limited_pendulum(jsc).compile()
    tscene, tstate = torch_scene_state(jscene, jstate)
    q = np.array([[0.49], [3.01], [0.3]])
    qd = np.array([[-0.7], [0.4], [0.2]])
    js = batch_jax_art_state(jstate, 3, q, qd)
    ts = batch_torch_art_state(tstate, 3, q, qd)
    nz = jcfg.near_zero(jnp.float64)

    def jfn(s):
        pt = jkin.compute(jscene, s)
        _, con = jnph.narrow_phase(jscene, pt.pos, pt.quat, jscene.contact_dist_thresh)
        act, act_lim, _, lim_vel = jimp._active(jscene, s, pt, con, nz)
        p = jimp.assemble_problem(jscene, s, pt, con, act, act_lim)
        return act_lim, lim_vel, p.Jl, p.A, p.bv

    ref = _jax_batched(jfn, js)
    pt = tkin.compute(tscene, ts)
    _, con = tnph.narrow_phase(tscene, pt.pos, pt.quat, tscene.contact_dist_thresh)
    act, act_lim, _, lim_vel = timp._active(tscene, ts, pt, con,
                                            tcfg.near_zero(torch.float64))
    p = timp.assemble_problem(tscene, ts, pt, con, act, act_lim)
    np.testing.assert_array_equal(t2n(act_lim), np.asarray(ref[0]))
    assert t2n(act_lim).tolist() == [[False, True], [True, False], [False, False]]
    for got, want in zip((lim_vel, p.Jl, p.A, p.bv), ref[1:]):
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t2n(tscene.lim_gc_col), [0, 0])
    np.testing.assert_array_equal(t2n(tscene.lim_upper), [True, False])


def test_noslip_on_table_first_contact(monkeypatch):
    """`select_st_indices`, `solve_noslip` and `resolve_impacts_noslip` on
    the table's first contact state (40 slots, 16 of them touching: 4 legs x
    4 bottom vertices): the S/T selection and the condensed LCP equal the
    JAX package's; the velocity change and the post-impact contact-space
    velocity to 1e-9. The LCP is redundant, so its z is not unique: each
    package's z solves the other's LCP within `_verify`'s tolerance
    m·‖M‖∞·√eps."""
    from moby_tpu.solvers import lcp as jlcp

    jscene, js, tscene, ts = _table_states(2, 4)
    nz = jcfg.near_zero(jnp.float64)
    problems = {"jax": [], "torch": []}

    def recording(who, real):
        def rec(M, q, mask, **kw):
            if who == "jax":      # inside jit: handed over at run time
                jax.debug.callback(
                    lambda *a: problems[who].append(tuple(np.asarray(x) for x in a)),
                    M, q, mask)
            else:
                problems[who].append(tuple(t2n(x) for x in (M, q, mask)))
            return real(M, q, mask, **kw)
        return rec

    monkeypatch.setattr(jlcp, "solve_lcp_fast_lemke",
                        recording("jax", jlcp.solve_lcp_fast_lemke))
    monkeypatch.setattr(lcp, "solve_lcp_fast_lemke",
                        recording("torch", lcp.solve_lcp_fast_lemke))

    @jax.jit
    def jfn(s):
        pt = jkin.compute(jscene, s)
        _, con = jnph.narrow_phase(jscene, pt.pos, pt.quat, jscene.contact_dist_thresh)
        act, act_lim, _, _ = jimp._active(jscene, s, pt, con, nz)
        p = jimp.assemble_problem(jscene, s, pt, con, act, act_lim)
        sS, sT = jns.select_st_indices(p, act, nz)
        cn, _, _, _, dv, _ = jns.solve_noslip(jscene, p, act, act_lim, nz)
        return act, sS, sT, cn, dv, p.Jn @ dv + p.Cn_v

    # one scenario at a time, so that the recorded M, q are one problem each
    ref = [[np.asarray(x) for x in jfn(jax.tree_util.tree_map(lambda x: x[b], js))]
           for b in range(2)]
    jax.effects_barrier()
    jprob = problems["jax"]
    ref = [np.stack(x) for x in zip(*ref)]

    pt = tkin.compute(tscene, ts)
    _, con = tnph.narrow_phase(tscene, pt.pos, pt.quat, tscene.contact_dist_thresh)
    tnz = tcfg.near_zero(torch.float64)
    act, act_lim, _, _ = timp._active(tscene, ts, pt, con, tnz)
    p = timp.assemble_problem(tscene, ts, pt, con, act, act_lim)
    sS, sT = tns.select_st_indices(p, act, tnz)
    cn, cs, ct, l, dv, _ = tns.solve_noslip(tscene, p, act, act_lim, tnz)
    res = tns.resolve_impacts_noslip(tscene, ts, pt, con, ts.zlast, ts.zlast_active)
    cn_vel = (p.Jn @ dv[..., None])[..., 0] + p.Cn_v

    assert int(act.sum()) == 2 * 16 and tscene.n_contacts == 40
    for got, want in zip((act, sS, sT), ref[:3]):
        np.testing.assert_array_equal(t2n(got), want)
    # every restitution is zero: the pipeline's dv is the first solve's
    for got, want in zip((dv, res.dv, cn_vel), (ref[4], ref[4], ref[5])):
        np.testing.assert_allclose(t2n(got), want, rtol=0, atol=TRAJ_TOL)
    assert float(cn_vel[act].min()) > -TRAJ_TOL          # the legs stop sinking
    assert float(cn.sum()) > 0

    M_t, q_t, mask_t = problems["torch"][0]
    for b in range(2):
        M_j, q_j, mask_j = jprob[b]
        np.testing.assert_array_equal(mask_t[b], mask_j)
        np.testing.assert_allclose(M_t[b], M_j, rtol=0, atol=TOL)
        np.testing.assert_allclose(q_t[b], q_j, rtol=0, atol=TOL)
        Mp, qp = lcp.pad_lcp(torch.tensor(M_j)[None], torch.tensor(q_j)[None],
                             torch.tensor(mask_j)[None])
        m = torch.tensor(mask_j)[None]
        tol = lcp._check_tol(Mp, m)
        for z in (cn[b], torch.tensor(ref[3][b])):
            assert bool(lcp._verify(Mp, qp, z[None], m, tol).all())


def _rollout_both(builder, dt, n_steps):
    """L∞ over the rollout of every state field that moves: the JAX
    package's jitted step against the port's batched one (B=1). Returns the
    port's final state and the error."""
    jscene, js = builder(jsc).compile()
    tscene, ts = torch_scene_state(jscene, js)
    jfn = jax.jit(lambda s: jstep.step(jscene, s, dt))
    err = 0.0
    for _ in range(n_steps):
        js = jfn(js)
        ts = tstep.step(tscene, ts, dt, device="cpu")
        for f in ("pos", "quat", "vel", "omega", "q_art", "qd_art", "time"):
            d = np.abs(np.asarray(getattr(js, f)) - t2n(getattr(ts, f))[0])
            err = max(err, float(d.max(initial=0.0)))
    return tscene, ts, err


def test_swing_matches_jax():
    _, ts, err = _rollout_both(build_swing, 1e-3, 60)
    assert err <= TRAJ_TOL
    assert abs(float(ts.q_art[0, 0]) - 1.0) > 0.01         # it swings


@pytest.mark.parametrize("restitution", [0.0, 0.5])
def test_joint_limit_stop_matches_jax(restitution):
    """Released from q=1 onto the lower stop at 0.5: the step's limit ETA,
    the limit rows of the impact LCP, the stabilization's limit slack, and
    with a restitution coefficient the limit's share of the restitution
    re-solve (it bounces back off the stop)."""
    tscene, ts, err = _rollout_both(
        lambda sc: build_limited_pendulum(sc, restitution), 1e-3, 330)
    assert tscene.n_limits == 2
    assert err <= TRAJ_TOL
    q = float(ts.q_art[0, 0])
    if restitution:
        assert q > 0.52 and float(ts.qd_art[0, 0]) > 0.0      # bounced
    else:
        assert 0.5 - 1e-3 < q < 0.52                           # at the stop


def test_noslip_restitution_matches_jax():
    """The no-slip model's restitution step: a sliding, spinning ball lands
    (mu = 200, epsilon = 0.5) and is in the air again at the end."""
    _, ts, err = _rollout_both(build_noslip_ball, 2e-3, 40)
    assert err <= TRAJ_TOL
    assert float(ts.pos[0, 0, 2]) > 0.5005                   # bounced


def test_pendulum_hits_ball_matches_jax():
    """A sphere on the pendulum's tip strikes the free ball (restitution
    0.5): contact rows through an articulated link and a free body, the
    restitution re-solve. Started at q=0.25 of the JAX test's swing, 40
    steps before the strike."""
    _, ts, err = _rollout_both(lambda sc: build_pendulum_ball(sc, 0.25), 2e-3, 60)
    assert err <= TRAJ_TOL
    v = t2n(ts.vel)[0, 0]
    assert v[0] < -0.1 and float(ts.qd_art[0, 0]) > -2.0     # struck


TABLE_STEPS = 20


@pytest.fixture(scope="module")
def table_jax_rollout():
    """The table (B=2) stepped by the JAX package, one scenario at a time
    through one jitted step: scenario 0 spins at the scene's own ω_z = 1,
    scenario 1 at ω_z drawn in [0.9, 1.1]. Returns (jscene, initial states
    q (2, 7), qd (2, 6), trajectory {field: (steps, 2, ...)})."""
    jscene, jstate, _, _ = load_table_both()
    q = np.broadcast_to(np.asarray(jstate.q_art), (2, 7)).copy()
    qd = np.zeros((2, 6))
    qd[:, 2] = [1.0, np.random.default_rng(5).uniform(0.9, 1.1)]
    jfn = jax.jit(lambda s: jstep.step(jscene, s, 1e-3))
    traj = {f: [] for f in ("pos", "quat", "vel", "omega", "q_art", "qd_art", "time")}
    per = []
    for b in range(2):
        s = jstate.replace(q_art=jnp.asarray(q[b]), qd_art=jnp.asarray(qd[b]))
        rows = []
        for _ in range(TABLE_STEPS):
            s = jfn(s)
            rows.append({f: np.asarray(getattr(s, f)) for f in traj})
        per.append(rows)
    for f in traj:
        traj[f] = np.stack([np.stack([per[b][k][f] for b in range(2)])
                            for k in range(TABLE_STEPS)])
    return q, qd, traj


@pytest.mark.parametrize("cascade", [None, "accel"], ids=["plain", "accel"])
def test_table_matches_jax(cascade, table_jax_rollout, monkeypatch):
    """20 steps of the table through the no-slip model. With
    cascade="accel" (the first 10 steps) the LCPs take `_solve_accel`, whose
    stage 2 is `ppm_lcp`'s plain version on the CPU: its calls are counted by
    size (the no-slip and stabilization LCPs are n = K + NL = 40).

    At the scene's own state (scenario 0) every field is held to 1e-9. The
    first step's no-slip LCP is singular to working precision (cond ~1e18:
    redundant contacts), its z is not unique and the block-pivoting iterate
    path through it is decided by rounding; on scenario 1 the two packages
    leave it on different bases, both accepted at m·‖M‖∞·√eps, and the
    leftover spin differs by 1e-7 rad/s. There positions are held to 1e-9
    and velocities to 1e-6."""
    q, qd, traj = table_jax_rollout
    _, _, tscene, tstate = load_table_both()
    ts = batch_torch_art_state(tstate, 2, q, qd)
    sizes = []
    wrapper = hopper_lcp.ppm_lcp

    def counting(M, q_, mask, z0=None, max_piv=None):
        sizes.append(M.shape[-1])
        return wrapper(M, q_, mask, z0=z0, max_piv=max_piv)

    monkeypatch.setattr(hopper_lcp, "ppm_lcp", counting)
    err = np.zeros((2, 2))            # (scenario, [positions, velocities])
    for k in range(TABLE_STEPS if cascade is None else TABLE_STEPS // 2):
        ts = tstep.step(tscene, ts, 1e-3, device="cpu", cascade=cascade)
        for f, col in (("pos", 0), ("quat", 0), ("q_art", 0), ("time", 0),
                       ("vel", 1), ("omega", 1), ("qd_art", 1)):
            d = np.abs(traj[f][k] - t2n(getattr(ts, f))).reshape(2, -1)
            err[:, col] = np.maximum(err[:, col], d.max(axis=1, initial=0.0))
    assert err[0].max() <= TRAJ_TOL, err
    assert err[1, 0] <= TRAJ_TOL and err[1, 1] <= 1e-6, err
    if cascade == "accel":
        assert sizes and set(sizes) == {40}
    else:
        assert not sizes
    # resting on its legs: no sinking, no drift in x and y
    qa = t2n(ts.q_art)
    assert np.abs(qa[:, :2]).max() < 1e-6 and np.abs(qa[:, 2] - 1.05).max() < 1e-4
