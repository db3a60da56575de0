"""PyTorch port: the articulated-body dynamics — `moby_tpu_torch.dynamics`
(`model.jcalc`, `joint_transforms`, `link_world_poses`; `aba.aba`, `crb`,
`rnea`, `fwd_dyn_crb`) and the spatial algebra under them, against
`moby_tpu.dynamics` and `moby_tpu.math.spatial`, float64 on the CPU.

The same joint coordinates, velocities and torques, made with numpy from a
seed, go through the JAX functions one scenario at a time and through the
port's batched ones. Straight-line code: held to 1e-10 (measured ~1e-15).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.dynamics import aba as jaba
from moby_tpu.dynamics import model as jmdl
from moby_tpu.math import spatial as jsp
from moby_tpu_torch.dynamics import aba as taba
from moby_tpu_torch.dynamics import model as tmdl
from moby_tpu_torch.math import spatial as tsp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import t2n

TOL = 1e-10
B = 4
GRAV = np.array([0.0, -9.81, 0.0])


def _rot(rng):
    Q, R = np.linalg.qr(rng.normal(size=(3, 3)))
    Q = Q * np.sign(np.diag(R))
    return Q if np.linalg.det(Q) > 0 else -Q


def _unit(rng, n=3):
    v = rng.normal(size=n)
    return v / np.linalg.norm(v)


def tree_model(seed=0):
    """A floating base with one link of every other joint type hanging off
    it (revolute, prismatic, spherical, universal, planar, fixed), random
    tree transforms, axes, inertias and tares."""
    rng = np.random.default_rng(seed)

    def link(name, jtype, **kw):
        j = jmdl.JointDef(jtype=jtype, Xt_E=_rot(rng), Xt_r=rng.normal(size=3),
                          name=name, **kw)
        A = rng.normal(size=(3, 3))
        return jmdl.LinkDef(name=name, mass=float(rng.uniform(0.5, 2.0)),
                            com=rng.normal(size=3) * 0.2,
                            inertia_com=A @ A.T + 0.1 * np.eye(3), joint=j)

    links = [
        link("base", jmdl.FLOATING),
        link("rev", jmdl.REVOLUTE, axis=_unit(rng), tare=np.array([0.3])),
        link("pri", jmdl.PRISMATIC, axis=_unit(rng), tare=np.array([-0.1])),
        link("sph", jmdl.SPHERICAL),
        link("uni", jmdl.UNIVERSAL, axis=_unit(rng), axis2=_unit(rng),
             tare=np.array([0.2, -0.4])),
        link("pla", jmdl.PLANAR, tare=np.array([0.1, 0.2, 0.3])),
        link("fix", jmdl.FIXED),
    ]
    m = jmdl.ArticulatedModel(links, floating=True)
    m.set_parents([-1, 0, 1, 0, 3, 2, 4])
    return m


def double_pendulum():
    def link(name, r):
        j = jmdl.JointDef(jtype=jmdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=np.asarray(r),
                          axis=np.array([0.0, 0, 1]))
        return jmdl.LinkDef(name=name, mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                            inertia_com=np.diag([1 / 12, 1e-12, 1 / 12]), joint=j)

    m = jmdl.ArticulatedModel([link("l1", [0, 0, 0]), link("l2", [0, -1.0, 0])],
                              floating=False)
    m.set_parents([-1, 0])
    return m


def random_q(m, rng, n=B):
    """(n, nq) coordinates with unit quaternions where the joint has one."""
    q = rng.normal(size=(n, m.nq))
    for i, t in enumerate(m.jtype):
        o = m.q_off[i]
        if t == jmdl.SPHERICAL:
            q[:, o: o + 4] /= np.linalg.norm(q[:, o: o + 4], axis=1, keepdims=True)
        elif t == jmdl.FLOATING:
            q[:, o + 3: o + 7] /= np.linalg.norm(q[:, o + 3: o + 7], axis=1,
                                                 keepdims=True)
    return q


def tt(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


MODELS = {"tree": tree_model, "double_pendulum": double_pendulum}


@pytest.mark.parametrize("jtype", sorted(jmdl.NQ))
def test_jcalc_matches_jax(jtype):
    """Every joint type, with a tare where the type takes one."""
    m = tree_model(1)
    i = m.jtype.index(jtype)
    jd = m.links[i].joint
    tm = tmdl.copy_model(m)
    q = random_q(m, np.random.default_rng(jtype))[:, m.q_off[i]: m.q_off[i] + jmdl.NQ[jtype]]
    X, S = tmdl.jcalc(tm.links[i].joint, jtype, tt(q))
    assert S.shape == (B, 6, jmdl.NV[jtype])
    for b in range(B):
        Xj, Sj = jmdl.jcalc(jd, jtype, jnp.asarray(q[b]))
        np.testing.assert_allclose(t2n(X.E[b]), np.asarray(Xj.E), rtol=0, atol=TOL)
        np.testing.assert_allclose(t2n(X.r[b]), np.asarray(Xj.r), rtol=0, atol=TOL)
        np.testing.assert_allclose(t2n(S[b]), np.asarray(Sj), rtol=0, atol=TOL)


def test_spatial_algebra_matches_jax():
    rng = np.random.default_rng(2)
    E = np.stack([_rot(rng) for _ in range(B)])
    r, v, f = (rng.normal(size=(B, k)) for k in (3, 6, 6))
    Xj, Xt = jsp.Transform(jnp.asarray(E), jnp.asarray(r)), tsp.Transform(tt(E), tt(r))
    I6 = np.asarray(jsp.inertia_matrix(jnp.asarray(1.7), jnp.asarray(r[0]),
                                       jnp.asarray(np.eye(3) * 0.3)))
    pairs = [
        (jsp.xform_motion(Xj, jnp.asarray(v)), tsp.xform_motion(Xt, tt(v))),
        (jsp.xform_force(Xj, jnp.asarray(f)), tsp.xform_force(Xt, tt(f))),
        (jsp.crm(jnp.asarray(v)), tsp.crm(tt(v))),
        (jsp.crf(jnp.asarray(v)), tsp.crf(tt(v))),
        (jsp.cross_motion(jnp.asarray(v), jnp.asarray(f)), tsp.cross_motion(tt(v), tt(f))),
        (jsp.cross_force(jnp.asarray(v), jnp.asarray(f)), tsp.cross_force(tt(v), tt(f))),
        (jsp.motion_matrix(Xj), tsp.motion_matrix(Xt)),
        (jsp.xform_inertia(Xj, jnp.asarray(I6)), tsp.xform_inertia(Xt, tt(I6))),
        (I6, tsp.inertia_matrix(tt(1.7), tt(r[0]), tt(np.eye(3) * 0.3))),
        (Xj.inv().E, Xt.inv().E), (Xj.inv().r, Xt.inv().r),
        (Xj.compose(Xj.inv()).r, Xt.compose(Xt.inv()).r),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(t2n(b), np.asarray(a), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_kinematics_match_jax(name):
    m = MODELS[name]()
    tm = tmdl.copy_model(m)
    q = random_q(m, np.random.default_rng(3))
    Xs, Ss = tmdl.joint_transforms(tm, tt(q))
    Rs, ps = tmdl.link_world_poses(tm, tt(q))
    np.testing.assert_allclose(tm.I_link, np.asarray(m.I_link), rtol=0, atol=1e-14)
    for b in range(B):
        Xj, Sj = jmdl.joint_transforms(m, jnp.asarray(q[b]))
        Rj, pj = jmdl.link_world_poses(m, jnp.asarray(q[b]))
        for i in range(m.nl):
            np.testing.assert_allclose(t2n(Xs[i].E[b]), np.asarray(Xj[i].E), atol=TOL)
            np.testing.assert_allclose(t2n(Xs[i].r[b]), np.asarray(Xj[i].r), atol=TOL)
            np.testing.assert_allclose(t2n(Ss[i][b]), np.asarray(Sj[i]), atol=TOL)
            np.testing.assert_allclose(t2n(Rs[i][b]), np.asarray(Rj[i]), atol=TOL)
            np.testing.assert_allclose(t2n(ps[i][b]), np.asarray(pj[i]), atol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_dynamics_match_jax(name):
    """aba, crb, rnea and fwd_dyn_crb, with external link forces on the
    tree; each against the JAX function at the same inputs."""
    m = MODELS[name]()
    tm = tmdl.copy_model(m)
    rng = np.random.default_rng(4)
    q = random_q(m, rng)
    qd, tau, qdd = (rng.normal(size=(B, m.nv)) for _ in range(3))
    fx = rng.normal(size=(B, m.nl, 6)) if name == "tree" else None
    fx_t = None if fx is None else [tt(fx[:, i]) for i in range(m.nl)]
    out = {
        "aba": taba.aba(tm, tt(q), tt(qd), tt(tau), GRAV, fx_t),
        "rnea": taba.rnea(tm, tt(q), tt(qd), tt(qdd), GRAV, fx_t),
        "crb": taba.crb(tm, tt(q)),
        "fwd_dyn_crb": taba.fwd_dyn_crb(tm, tt(q), tt(qd), tt(tau), GRAV, fx_t),
    }
    for b in range(2):      # the JAX functions one scenario at a time
        fj = None if fx is None else [jnp.asarray(fx[b, i]) for i in range(m.nl)]
        args = (jnp.asarray(q[b]), jnp.asarray(qd[b]))
        ref = {
            "aba": jaba.aba(m, *args, jnp.asarray(tau[b]), jnp.asarray(GRAV), fj),
            "rnea": jaba.rnea(m, *args, jnp.asarray(qdd[b]), jnp.asarray(GRAV), fj),
            "crb": jaba.crb(m, args[0]),
            "fwd_dyn_crb": jaba.fwd_dyn_crb(m, *args, jnp.asarray(tau[b]),
                                            jnp.asarray(GRAV), fj),
        }
        for k in out:
            np.testing.assert_allclose(t2n(out[k][b]), np.asarray(ref[k]),
                                       rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_aba_equals_crb_inverse(name):
    """ABA = H⁻¹(τ − C) with C from RNEA at qdd = 0 (the reference's fsab
    and crb options agree), and RNEA inverts ABA."""
    m = tmdl.copy_model(MODELS[name]())
    rng = np.random.default_rng(5)
    q = tt(random_q(m, rng))
    qd, tau = (tt(rng.normal(size=(B, m.nv))) for _ in range(2))
    a1 = taba.aba(m, q, qd, tau, GRAV)
    H = taba.crb(m, q)
    C = taba.rnea(m, q, qd, torch.zeros_like(qd), GRAV)
    a2 = torch.linalg.solve(H, tau - C)
    torch.testing.assert_close(a1, a2, rtol=0, atol=1e-9)
    torch.testing.assert_close(taba.rnea(m, q, qd, a1, GRAV), tau, rtol=0, atol=1e-9)
    torch.testing.assert_close(H, H.transpose(-1, -2), rtol=0, atol=1e-12)
