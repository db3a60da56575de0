"""PyTorch port: the other contact models — bilateral constraints
(`sim.bilateral`), compliant penalty contact (`stepper.penalty_forces`),
per-island model routing (`impact.island_labels`, `group_labels`,
`model_masks`) and the true-cone NQP (`sim.nqp`) — against the JAX package,
float64 on the CPU, scenes built in code with numpy-made jitter.

Straight-line code (the bilateral rows, J̇q̇ and the three corrections, the
penalty forces) is held to 1e-10, labels exactly, the NQP's fixed-count
ALM-APGD to 1e-9, and whole-step trajectories of every model to L∞ 1e-8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.sim import bilateral as jbil
from moby_tpu.sim import impact as jimp
from moby_tpu.sim import kinematics as jkin
from moby_tpu.sim import nqp as jnqp
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.sim import bilateral as tbil
from moby_tpu_torch.sim import impact as timp
from moby_tpu_torch.sim import kinematics as tkin
from moby_tpu_torch.sim import nqp as tnqp
from moby_tpu_torch.sim import stepper as tstep
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    build_compliant_ball, build_gear_pendulum, build_nqp_ball, build_planar_box,
    build_point_chain, build_sliding_spheres, build_sphere_chain, jittered_pair,
    plane_quat, t2n,
)

B = 2
NZ = 1.4901161193847656e-08


def _unbatched(jst, i):
    return jax.tree_util.tree_map(lambda x: x[i], jst)


def _close(t, j, tol, what):
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0, atol=tol, err_msg=what)


BILATERAL_SCENES = {
    "gear": (build_gear_pendulum, dict(dqd=0.5)),
    "point": (build_point_chain, dict(dv=0.3, dw=0.5)),
    "planar": (build_planar_box, dict(dz=0.05, dv=0.3, dw=0.5)),
}


@pytest.mark.parametrize("name", list(BILATERAL_SCENES))
def test_bilateral_rows_and_corrections_match_jax(name):
    """`constraint_rows`, `jdot_qd` (forward-mode AD against `jax.jvp`),
    the projected inverse inertia and the velocity and acceleration
    corrections, on jittered states off the constraint manifold."""
    build, jit_kw = BILATERAL_SCENES[name]
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    assert len(tscene.bilaterals) == len(jscene.bilaterals) > 0
    jst, tst = jittered_pair(jscene, jstate, B, seed=3, **jit_kw)
    rng = np.random.default_rng(4)
    a_free = rng.normal(size=(B, jscene.ngc))

    pt = tkin.compute(tscene, tst)
    J, C = tbil.constraint_rows(tscene, tst, pt)
    jd = tbil.jdot_qd(tscene, tst)
    Minv = timp.gc_inv_inertia(tscene, tst, tst.quat)
    v = tkin.gc_velocity(tscene, tst)
    a = torch.as_tensor(a_free)
    X = tbil.project_inv_inertia(Minv, J)
    dv = tbil.velocity_correction(Minv, J, v)
    acc = tbil.acceleration_correction(Minv, J, a, jd)
    assert J.shape == (B, tbil.total_rows(tscene), tscene.ngc)

    def jfun(s, a_j):
        Jj, Cj = jbil.constraint_rows(jscene, s, jkin.compute(jscene, s))
        jdj = jbil.jdot_qd(jscene, s)
        Mj = jimp.gc_inv_inertia(jscene, s, s.quat)
        return (Jj, Cj, jdj, jbil.project_inv_inertia(Mj, Jj),
                jbil.velocity_correction(Mj, Jj, jkin.gc_velocity(jscene, s)),
                jbil.acceleration_correction(Mj, Jj, a_j, jdj))

    jfun = jax.jit(jfun)
    for i in range(B):
        outs = jfun(_unbatched(jst, i), jnp.asarray(a_free[i]))
        for t, j, what in zip((J, C, jd, X, dv, acc), outs,
                              ("J", "C", "jdot_qd", "X", "dv", "a")):
            _close(t[i], j, 1e-10, what)
    # the corrections do what they are for: J·(v + Δv) = 0, J·a = −J̇q̇
    assert float((J @ (v + dv)[..., None]).abs().max()) < 1e-9
    assert float(((J @ acc[..., None])[..., 0] + jd).abs().max()) < 1e-9
    if name == "point":
        # the rows turn with the bodies (a gear's are constant, and so are a
        # planar joint's to the fixed ground)
        assert float(jd.abs().max()) > 1e-3


def _compliant_box(sc):
    """A compliant box pressed tilted into the plane, sliding: several of its
    vertex slots are inside, so the deepest one per pair is chosen, and
    mu_viscous > 0 gives the sliding friction a sign."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    q = np.array([0.02, -0.03, 0.01, 1.0])
    b.add_body("box", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.15, 0.1),
               pos=np.array([0.0, 0.0, 0.095]), quat=q / np.linalg.norm(q),
               lin_vel=np.array([0.4, -0.2, -0.1]), compliant=True)
    b.add_geom("box", sc.BOX, [0.2, 0.15, 0.1])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "box", sc.ContactParams(
        penalty_kp=4000.0, penalty_kv=30.0, mu_viscous=0.3))
    b.stab_max_iters = 0
    return b


@pytest.mark.parametrize(
    "build", [lambda sc: build_compliant_ball(sc, z0=0.495), _compliant_box],
    ids=["ball", "box"])
def test_penalty_forces_match_jax(build):
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    assert tscene.has_compliant and bool(tscene.slot_compliant.all())
    jst, tst = jittered_pair(jscene, jstate, B, seed=5, dz=-0.01, dv=0.2, dw=0.5)
    pt = tkin.compute(tscene, tst)
    _, con = tnph.narrow_phase(tscene, pt.pos, pt.quat, tscene.contact_dist_thresh)
    f = tstep.penalty_forces(tscene, pt, con)
    for i in range(B):
        s = _unbatched(jst, i)
        jpt = jkin.compute(jscene, s)
        _, jcon = jnph.narrow_phase(jscene, jpt.pos, jpt.quat,
                                    jscene.contact_dist_thresh)
        _close(f[i], jstep.penalty_forces(jscene, jpt, jcon), 1e-10, "f_gc")
    assert float(f[:, 2].min()) > 0.0            # the plane pushes up


def _labels_scenes():
    return {
        "mixed": (lambda sc: build_sliding_spheres(sc), dict(dz=-2e-3, dv=0.2)),
        "chain": (lambda sc: build_sphere_chain(sc, n=3, height=0.2),
                  dict(dz=-2e-3, dv=0.2)),
    }


@pytest.mark.parametrize("name", ["mixed", "chain"])
def test_island_labels_and_model_masks_match_jax(name):
    """Islands through contacts and point joints, the constraint groups of
    every slot, and the per-island model routing: exact."""
    build, jit_kw = _labels_scenes()[name]
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    jst, tst = jittered_pair(jscene, jstate, B, seed=6, **jit_kw)
    pt = tkin.compute(tscene, tst)
    _, con = tnph.narrow_phase(tscene, pt.pos, pt.quat, tscene.contact_dist_thresh)
    labels = timp.island_labels(tscene, con.active)
    groups = timp.group_labels(tscene, con)
    masks = timp.model_masks(tscene, con)
    assert bool(con.active.any())
    for i in range(B):
        s = _unbatched(jst, i)
        jpt = jkin.compute(jscene, s)
        _, jcon = jnph.narrow_phase(jscene, jpt.pos, jpt.quat,
                                    jscene.contact_dist_thresh)
        np.testing.assert_array_equal(t2n(con.active[i]), np.asarray(jcon.active))
        np.testing.assert_array_equal(
            t2n(labels[i]), np.asarray(jimp.island_labels(jscene, jcon.active)))
        for t, j in zip(groups, jimp.group_labels(jscene, jcon)):
            np.testing.assert_array_equal(t2n(t[i]), np.asarray(j))
        for tm, jm in zip(masks, jimp.model_masks(jscene, jcon)):
            for t, j in zip(tm, jm):
                np.testing.assert_array_equal(t2n(t[i]), np.asarray(j))
    if name == "mixed":
        # one island per model: no-slip, QP, NQP
        (ns, _), (nq, _), (qp, _) = masks
        assert tscene.mixed_models and tscene.use_nqp
        assert [bool(m[0, k]) for m in (ns, qp, nq) for k in range(3)] == [
            True, False, False, False, True, False, False, False, True]
    else:
        # the point joints tie the chain into one island with the anchor
        assert int(labels[0, 1:4].max()) == int(labels[0, 1:4].min())


def _nqp_problem_states():
    """The `tests/test_nqp.py` ball pressed into the plane in two members:
    sliding fast (the cone's edge) and slowly with a spin (inside it)."""
    jscene, jstate = build_nqp_ball(jsc, z0=1.0 - 1e-4, mu=0.4).compile()
    tscene, _ = build_nqp_ball(tsc, z0=1.0 - 1e-4, mu=0.4).compile(device="cpu")
    vel = np.array([[[3.0, 0.0, -0.5], [0, 0, 0]], [[0.05, 0.02, -1.0], [0, 0, 0]]])
    omega = np.array([[[0.0, 0.0, 0.0], [0, 0, 0]], [[0.3, -0.2, 1.0], [0, 0, 0]]])
    jst, tst = jittered_pair(jscene, jstate, B, seed=0)
    jst = jst.replace(vel=jnp.asarray(vel), omega=jnp.asarray(omega))
    tst = tst.replace(vel=torch.as_tensor(vel), omega=torch.as_tensor(omega))
    return jscene, tscene, jst, tst


def test_solve_nqp_and_resolve_impacts_nqp_match_jax():
    jscene, tscene, jst, tst = _nqp_problem_states()
    assert tscene.use_nqp and not tscene.mixed_models

    def jfun(s):
        pt = jkin.compute(jscene, s)
        _, con = jnph.narrow_phase(jscene, pt.pos, pt.quat,
                                   jscene.contact_dist_thresh)
        act, act_lim, _, _ = jimp._active(jscene, s, pt, con, NZ)
        p = jimp.assemble_problem(jscene, s, pt, con, act, act_lim)
        sol = jnqp.solve_nqp(jscene, p, act, act_lim)
        res = jnqp.resolve_impacts_nqp(jscene, s, pt, con, s.zlast,
                                       s.zlast_active)
        return sol[:5], sol[5].pivots, res

    jfun = jax.jit(jfun)
    (jsol, jpiv, jres) = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[jfun(_unbatched(jst, i)) for i in range(B)])
    pt = tkin.compute(tscene, tst)
    _, con = tnph.narrow_phase(tscene, pt.pos, pt.quat, tscene.contact_dist_thresh)
    act, act_lim, _, _ = timp._active(tscene, tst, pt, con, NZ)
    p = timp.assemble_problem(tscene, tst, pt, con, act, act_lim)
    sol = tnqp.solve_nqp(tscene, p, act, act_lim)
    for t, j, what in zip(sol[:5], jsol, ("cn", "cs", "ct", "l", "dv")):
        _close(t, j, 1e-9, what)
    np.testing.assert_array_equal(t2n(sol[5].pivots), np.asarray(jpiv))
    res = tnqp.resolve_impacts_nqp(tscene, tst, pt, con, tst.zlast, tst.zlast_active)
    _close(res.dv, jres.dv, 1e-9, "resolve dv")
    _close(res.impulses_n, jres.impulses_n, 1e-9, "resolve cn")
    np.testing.assert_array_equal(t2n(res.zlast_active), np.asarray(jres.zlast_active))
    np.testing.assert_array_equal(t2n(res.pivots), np.asarray(jres.pivots))
    # the true cone: the sliding member's friction sits on the cone,
    # |c_t| = mu·c_n; the slow one sticks inside it
    cn, cs, ct = (t2n(x)[:, 0] for x in sol[:3])
    assert cn.min() > 0.0
    assert abs(np.hypot(cs[0], ct[0]) - 0.4 * cn[0]) < 1e-6 * cn[0]
    assert np.hypot(cs[1], ct[1]) < 0.4 * cn[1]


TRAJECTORIES = {
    # name: (builder, dt, steps, jitter)
    "nqp": (lambda sc: build_nqp_ball(sc, z0=1.0 + 2e-4), 1e-3, 12,
            dict(dz=1e-4, dv=0.1)),
    "mixed": (build_sliding_spheres, 1e-3, 10, dict(dz=1e-4, dv=0.1)),
    "compliant": (lambda sc: build_compliant_ball(sc, z0=0.5), 1e-3, 20,
                  dict(dz=-0.01, dv=0.1)),
    "point_chain": (build_point_chain, 2e-3, 20, dict(dv=0.1, dw=0.2)),
    "gear_pendulum": (build_gear_pendulum, 1e-3, 20, dict(dqd=0.3)),
    "planar_box": (build_planar_box, 1e-3, 20, dict(dz=2e-4, dv=0.1, dw=0.2)),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_step_trajectory_matches_jax(name):
    """Whole steps of each model, batched with jitter, from the port's own
    compile: positions, orientations, velocities and joint coordinates of
    the whole rollout within L∞ 1e-8 of `jax.vmap(stepper.step)`."""
    build, dt, n_steps, jit_kw = TRAJECTORIES[name]
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    jst, tst = jittered_pair(jscene, jstate, B, seed=7, **jit_kw)
    v0 = t2n(tst.vel)
    # one compile, each member stepped on its own (vmap would double it)
    step = jax.jit(lambda s: jstep.step(jscene, s, dt))
    js = [_unbatched(jst, i) for i in range(B)]
    err, pivots = 0.0, 0
    for _ in range(n_steps):
        js = [step(s) for s in js]
        tst = tstep.step(tscene, tst, dt, device="cpu")
        for f in ("pos", "quat", "vel", "omega", "q_art", "qd_art", "time"):
            jv = np.stack([np.asarray(getattr(s, f)) for s in js])
            err = max(err, float(np.abs(jv - t2n(getattr(tst, f))).max(initial=0.0)))
        np.testing.assert_array_equal(
            t2n(tst.solver_pivots), [int(s.solver_pivots) for s in js])
        pivots += int(t2n(tst.solver_pivots).sum())
    assert err <= 1e-8, err
    if tscene.has_compliant:
        # the spring holds the ball up, and no rigid impact was solved
        assert pivots == 0
        assert np.all(t2n(tst.vel[:, 0, 2]) > v0[:, 0, 2] - 9.81 * dt * n_steps + 1e-2)
    elif tscene.n_contacts:
        assert pivots > 0                  # impacts were really solved
    if tscene.bilaterals:
        _, C = tbil.constraint_rows(tscene, tst, tkin.compute(tscene, tst))
        assert float(C.abs().max()) < 1e-4
