"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through a function of the
JAX package `moby_tpu` and through its counterpart in `moby_tpu_torch`; data
crosses between the two frameworks as numpy arrays only. Both run on the CPU
in float64 unless a test says otherwise.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.dynamics import model as jmdl
from moby_tpu.io import mobyxml as jxml
from moby_tpu.math import quaternion as jquat
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.dynamics import model as tmdl

PLANE_RPY = [1.5707963267949, 0, 0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Every port test file imports this: its tensors are small, so PyTorch's
    intra-op threads only add synchronisation, and with six test workers on
    the machine they take cores from the others (the three MPC test files ran
    1.6 times as fast on one thread, with a third of the CPU time). The
    previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TABLE_XML = "scenes/fixed-articulated-table.xml"
SITTING_BOX_XML = "scenes/sitting-box.xml"


def plane_quat():
    return np.asarray(jquat.from_rpy(jnp.array(PLANE_RPY)))


def build_stack(sc, nk=16, mu=0.5, eps=0.3):
    """The 3-sphere friction+restitution stack of the repo's benchmark, on
    the scene module `sc` of either package."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    inertia = sc.sphere_inertia(1.0, 1.0)
    b.add_body("sph1", mass=1.0, inertia=inertia, pos=np.array([0, 0, 1.0]))
    b.add_body("sph2", mass=1.0, inertia=inertia, pos=np.array([0, 0, 3.0]))
    b.add_body("sph3", mass=1.0, inertia=inertia, pos=np.array([0, 0, 5.0]))
    b.add_body("ground", enabled=False)
    for n in ("sph1", "sph2", "sph3"):
        b.add_geom(n, sc.SPHERE, [1.0])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    cp = sc.ContactParams(epsilon=eps, mu_coulomb=mu, nk=nk)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    return b


def build_ballpush(sc):
    """The ball-push scene of the repo's contact-MPC benchmark."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4))
    return b


def build_blockpush(sc):
    """The block-push scene of `examples/block_push_mpc.py`: a 0.2 m cube of
    1 kg resting on the plane, mu=0.3, nk=4 (K=8 vertex slots, the QP-KKT
    LCP has n=64)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("block", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
               pos=np.array([0.0, 0.0, 0.2]))
    b.add_geom("block", sc.BOX, [0.2, 0.2, 0.2])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "block", sc.ContactParams(mu_coulomb=0.3, nk=4))
    return b


def blockpush_costs(target=(0.6, 0.3)):
    """(jax cost, jax cost_final, torch cost, torch cost_final) of
    `examples/block_push_mpc.py`; the JAX pair takes one scenario, the
    port's a batch."""
    tj = jnp.asarray(target)

    def jcost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def jfinal(x):
        return 100.0 * jnp.sum((x[0:2] - tj) ** 2)

    def tcost(x, u):
        return 1e-4 * (u[:, :6] ** 2).sum(dim=1)

    def tfinal(x):
        tt = torch.as_tensor(target, dtype=x.dtype, device=x.device)
        return 100.0 * ((x[:, 0:2] - tt) ** 2).sum(dim=1)

    return jcost, jfinal, tcost, tfinal


def blockpush_both(dtype=torch.float64):
    """The block-push scene compiled by the JAX package and carried into the
    port: (jscene, jstate, tscene, tstate)."""
    jscene, jstate = build_blockpush(jsc).compile()
    return (jscene, jstate) + torch_scene_state(jscene, jstate, dtype)


def build_box_on_plane(sc):
    """A box dropped slightly tilted onto the plane, with a sphere on top."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    q = np.asarray(jquat.from_rpy(jnp.array([0.02, -0.03, 0.3])))
    b.add_body("box", mass=2.0, inertia=sc.box_inertia(2.0, 0.5, 0.4, 0.3),
               pos=np.array([0.0, 0.0, 0.3005]), quat=q,
               lin_vel=np.array([0.3, 0.0, -0.2]))
    b.add_body("ball", mass=0.5, inertia=sc.sphere_inertia(0.5, 0.25),
               pos=np.array([0.1, 0.05, 0.8506]))
    b.add_body("ground", enabled=False)
    b.add_geom("box", sc.BOX, [0.5, 0.4, 0.3])
    b.add_geom("ball", sc.SPHERE, [0.25])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params(
        "ground", "box", sc.ContactParams(epsilon=0.1, mu_coulomb=0.4, nk=4))
    b.set_contact_params(
        "ball", "box", sc.ContactParams(epsilon=0.2, mu_coulomb=0.3, nk=4))
    b.set_contact_params(
        "ball", "ground", sc.ContactParams(epsilon=0.0, mu_coulomb=0.3, nk=4))
    return b


def build_box_on_box(sc, max_slots=0):
    """A box dropped slightly tilted onto a fixed box (box-box contact);
    `max_slots` caps the pair's contact slots (the deepest-vertex route)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    q = np.asarray(jquat.from_rpy(jnp.array([0.015, -0.02, 0.4])))
    b.add_body("box", mass=2.0, inertia=sc.box_inertia(2.0, 0.3, 0.25, 0.2),
               pos=np.array([0.05, -0.02, 0.7004]), quat=q,
               lin_vel=np.array([0.2, 0.0, -0.1]))
    b.add_body("base", enabled=False, pos=np.array([0.0, 0.0, 0.25]))
    b.add_geom("box", sc.BOX, [0.3, 0.25, 0.2])
    b.add_geom("base", sc.BOX, [1.0, 1.0, 0.25])
    b.set_contact_params("base", "box", sc.ContactParams(
        epsilon=0.1, mu_coulomb=0.4, nk=4, max_slots=max_slots))
    return b


def pendulum_model(mdl, lo=None, hi=None, restitution=0.0):
    """`tests/test_articulated_sim.py::pendulum_model` on the dynamics model
    module `mdl` of either package: a 1 m rod of 1 kg on a revolute joint
    about z, optionally limited to [lo, hi]."""
    j = mdl.JointDef(
        jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=np.zeros(3),
        axis=np.array([0.0, 0, 1]),
        lo=np.array([lo]) if lo is not None else None,
        hi=np.array([hi]) if hi is not None else None,
        restitution=restitution,
    )
    link = mdl.LinkDef(name="rod", mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                       inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]), joint=j)
    m = mdl.ArticulatedModel([link], floating=False)
    m.set_parents([-1])
    return m


def _mdl(sc):
    return jmdl if sc is jsc else tmdl


def build_swing(sc):
    """`test_articulated_sim.py`'s swinging pendulum, from q=1."""
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("pend", pendulum_model(_mdl(sc)), q0=np.array([1.0]))
    return b


def build_limited_pendulum(sc, restitution=0.0):
    """`test_articulated_sim.py`'s pendulum released from q=1 against a
    hard lower limit at 0.5 (and an upper one at 3.0)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("pend", pendulum_model(_mdl(sc), lo=0.5, hi=3.0,
                                             restitution=restitution),
                      q0=np.array([1.0]))
    return b


def build_limited_double_pendulum(sc, q0=(0.5, 0.3), qd0=(-0.5, 0.2)):
    """The double pendulum of `examples/double_pendulum.py` (two 1 m rods of
    1 kg on revolute joints about z, gravity along -y) with the first joint
    limited to [0.5, 3.0] as in the repo's limited-pendulum tests, started on
    its lower limit and moving into it, so the limit row is active."""
    mdl = _mdl(sc)

    def link(name, parent_r, lo=None, hi=None):
        j = mdl.JointDef(
            jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=parent_r,
            axis=np.array([0.0, 0, 1]),
            lo=None if lo is None else np.array([lo]),
            hi=None if hi is None else np.array([hi]),
        )
        return mdl.LinkDef(name=name, mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                           inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]),
                           joint=j)

    m = mdl.ArticulatedModel(
        [link("l1", np.zeros(3), lo=0.5, hi=3.0),
         link("l2", np.array([0.0, -1.0, 0.0]))], floating=False)
    m.set_parents([-1, 0])
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("dp", m, q0=np.array(q0), qd0=np.array(qd0))
    return b


def build_pendulum_ball(sc, q0=np.pi / 2):
    """`test_articulated_sim.py`'s pendulum with a sphere on its tip swinging
    (qd=-2 rad/s, no gravity) into a free ball: contacts with restitution
    0.5 between an articulated link and a free body. `q0` moves the start
    along the same swing (π/2 in the JAX test)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, 0])
    b.add_articulated("pend", pendulum_model(_mdl(sc)), q0=np.array([q0]),
                      qd0=np.array([-2.0]))
    b.add_geom("pend/rod", sc.SPHERE, [0.1], pos=np.array([0, -1.0, 0]))
    b.add_body("ball", mass=0.1, inertia=sc.sphere_inertia(0.1, 0.1),
               pos=np.array([0.15, -1.1, 0.0]))
    b.add_geom("ball", sc.SPHERE, [0.1])
    b.set_contact_params(
        "pend", "ball", sc.ContactParams(epsilon=0.5, mu_coulomb=0.0, nk=4))
    return b


def build_noslip_ball(sc):
    """A ball dropped onto the plane with infinite friction (mu >= 100: the
    no-slip model) and restitution 0.5, sliding and spinning as it lands."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.52]), lin_vel=np.array([0.3, -0.1, 0.0]),
               ang_vel=np.array([0.0, 0.0, 2.0]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=0.5, mu_coulomb=200.0, nk=4))
    return b


def load_table_both():
    """The repo's articulated table scene (`scenes/fixed-articulated-table.xml`)
    loaded by the JAX package and carried across into the port (CPU,
    float64). Returns (jscene, jstate, tscene, tstate)."""
    jscene, jstate, _ = jxml.load(TABLE_XML)
    return (jscene, jstate) + torch_scene_state(jscene, jstate)


def jax_fields(obj):
    """A compiled JAX Scene/State as a dict of numpy arrays and statics."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = np.asarray(v) if isinstance(v, jax.Array) else v
    return out


def torch_scene_state(jscene, jstate, dtype=torch.float64):
    """The port's Scene/State on the CPU from the JAX package's compiled
    ones, so both sides compute on the same tables."""
    return (tsc.scene_from_arrays(jax_fields(jscene), "cpu", dtype),
            tsc.state_from_arrays(jax_fields(jstate), "cpu", dtype))


def batch_jax_state(jstate, B, dz):
    """B copies of a JAX state with per-scenario height jitter dz (B, nb)."""
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate)
    return batched.replace(pos=batched.pos.at[:, :, 2].add(jnp.asarray(dz)))


def batch_jax_art_state(jstate, B, q_art, qd_art):
    """B copies of a JAX state with per-scenario q_art/qd_art (B, n)."""
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate)
    return batched.replace(q_art=jnp.asarray(q_art), qd_art=jnp.asarray(qd_art))


def batch_torch_art_state(tstate, B, q_art, qd_art):
    st = tstate.expand(B)
    return st.replace(q_art=torch.as_tensor(q_art, dtype=st.pos.dtype),
                      qd_art=torch.as_tensor(qd_art, dtype=st.pos.dtype))


def batch_torch_state(tstate, B, dz):
    st = tstate.expand(B)
    pos = st.pos.clone()
    pos[:, :, 2] += torch.as_tensor(dz, dtype=pos.dtype)
    return st.replace(pos=pos)


def t2n(x):
    return x.detach().cpu().numpy()


def make_monotone(B, n, seed=0, dtype=np.float64, delta=0.5):
    """M = A Aᵀ + δI, q ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(dtype)
    Ms = np.einsum("bij,bkj->bik", A, A) + delta * np.eye(n, dtype=dtype)
    qs = rng.normal(size=(B, n)).astype(dtype)
    return Ms, qs


def make_kkt(B, nv, ni, seed=0, dtype=np.float64):
    """KKT-shaped LCPs [[H, -Gᵀ], [G, 0]] with H SPD: the shape of the impact
    QP's stack (monotone, not symmetric, zero lower-right block)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, nv, nv))
    H = np.einsum("bij,bkj->bik", A, A) + 0.3 * np.eye(nv)
    G = rng.normal(size=(B, ni, nv))
    M = np.zeros((B, nv + ni, nv + ni))
    M[:, :nv, :nv] = H
    M[:, :nv, nv:] = -np.transpose(G, (0, 2, 1))
    M[:, nv:, :nv] = G
    q = np.concatenate(
        [rng.normal(size=(B, nv)), np.abs(rng.normal(size=(B, ni)))], axis=1)
    return M.astype(dtype), q.astype(dtype)


def ballpush_both(B, seed=0, spread=0.1, dtype=torch.float64):
    """The ball-push MPC task of the repo's benchmark on both sides: the
    scene and state compiled by the JAX package and loaded into the port, B
    scenarios with a numpy-made x jitter of the ball in [-spread, spread).
    Returns (jscene, jstate, jbatched, tscene, tstate, tbatched, dx)."""
    jscene, jstate = build_ballpush(jsc).compile()
    tscene, tstate = torch_scene_state(jscene, jstate, dtype)
    dx = np.random.default_rng(seed).uniform(size=B) * 2 * spread - spread
    jb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate)
    jb = jb.replace(pos=jb.pos.at[:, 0, 0].add(jnp.asarray(dx)))
    tb = tstate.expand(B)
    pos = tb.pos.clone()
    pos[:, 0, 0] += torch.as_tensor(dx, dtype=pos.dtype)
    return jscene, jstate, jb, tscene, tstate, tb.replace(pos=pos), dx


def ballpush_costs(target=(0.4, 0.0)):
    """(jax cost, jax cost_final, torch cost, torch cost_final): the
    benchmark's costs; the JAX pair takes one scenario, the port's a batch."""
    tj = jnp.asarray(target)

    def jcost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def jfinal(x):
        return 50.0 * jnp.sum((x[0:2] - tj) ** 2)

    def tcost(x, u):
        return 1e-4 * (u[:, :6] ** 2).sum(dim=1)

    def tfinal(x):
        tt = torch.as_tensor(target, dtype=x.dtype, device=x.device)
        return 50.0 * ((x[:, 0:2] - tt) ** 2).sum(dim=1)

    return jcost, jfinal, tcost, tfinal


def ilqr_arrays(res):
    """An ILQRResult of either package as numpy arrays (us, xs, cost)."""
    conv = t2n if isinstance(res.cost, torch.Tensor) else np.asarray
    return conv(res.us), conv(res.xs), conv(res.cost)


def assert_same_fields(tobj, jfields, names):
    """The port's Scene/State fields `names` equal the JAX package's (a
    dict from `jax_fields`); a single-scenario JAX state against the
    port's batch of 1."""
    for k in names:
        tv, jv = getattr(tobj, k), jfields[k]
        if isinstance(tv, torch.Tensor):
            tv = t2n(tv)
            if jv.ndim == tv.ndim - 1:       # State: leading batch of 1
                tv = tv[0]
            assert tv.shape == jv.shape, k
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert tv == jv, k


def assert_same_compiled(tscene, tstate, jscene, jstate):
    """The port's compiled Scene/State equal the JAX package's: every array
    and static, the hull tables (directions as sets), the kind groups, and
    each articulated body's offsets and model tables (equal, not close: both
    run the same host-side numpy)."""
    assert_same_fields(tscene, jax_fields(jscene),
                       tsc._SCENE_ARRAYS + tsc._SCENE_STATICS + ("body_names",))
    assert_same_fields(tstate, jax_fields(jstate), tsc._STATE_ARRAYS)
    assert_same_hulls(tscene, jax_fields(jscene))
    assert set(tscene.kind_groups) == set(jscene.kind_groups)
    for key, grp in jscene.kind_groups.items():
        for f in ("pairs", "slots"):
            np.testing.assert_array_equal(tscene.kind_groups[key][f], grp[f])
    assert len(tscene.arts) == len(jscene.arts)
    for te, je in zip(tscene.arts, jscene.arts):
        assert (te.name, te.gc_off, te.q_off, te.v_off) == (
            je.name, je.gc_off, je.q_off, je.v_off)
        tm, jm = te.model, je.model
        assert (tm.parent, tm.jtype, tm.q_off, tm.v_off, tm.floating) == (
            jm.parent, jm.jtype, jm.q_off, jm.v_off, jm.floating)
        np.testing.assert_array_equal(tm.I_link, np.asarray(jm.I_link))
        for tl, jl in zip(tm.links, jm.links):
            assert (tl.name, tl.mass) == (jl.name, jl.mass)
            for f in ("Xt_E", "Xt_r", "axis", "axis2", "lo", "hi", "tare"):
                a, b = getattr(tl.joint, f), getattr(jl.joint, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
            assert tl.joint.restitution == jl.joint.restitution


# ---- the other contact models: scenes built in code, on either package ----

def build_nqp_ball(sc, z0=1.0, vel=(1.2, 0.7, 0.0), mu=0.3, eps=0.0, nk=0):
    """`tests/test_nqp.py`'s ball on a plane; nk=0 is the true friction cone
    (the NQP model)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 1.0),
               pos=np.array([0, 0, z0]), lin_vel=np.array(vel, float))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [1.0])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=eps, mu_coulomb=mu, nk=nk))
    return b


def build_sliding_spheres(sc, params=((1e8, 4), (0.2, 4), (0.3, 0))):
    """`tests/test_mixed_models.py`'s spheres sliding on one plane, 10 m
    apart (one island each, their mutual pairs disabled), each with its own
    (mu, nk): by default a no-slip, a QP and a true-cone (NQP) island, so
    one step routes three impact models."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    names = [f"s{i}" for i in range(len(params))]
    for i, n in enumerate(names):
        b.add_body(n, mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
                   pos=np.array([10.0 * i, 0, 0.5]), lin_vel=np.array([1.0, 0, 0]))
        b.add_geom(n, sc.SPHERE, [0.5])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    for n, (mu, nk) in zip(names, params):
        b.set_contact_params(
            "ground", n, sc.ContactParams(epsilon=0.0, mu_coulomb=mu, nk=nk))
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            b.disabled_pairs.add(tuple(sorted((names[i], names[j]))))
    return b


def build_compliant_ball(sc, kp=5000.0, kv=100.0, z0=0.6):
    """`tests/test_compliant.py`'s compliant ball (penalty contact,
    stabilization off)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, z0]), compliant=True)
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "ball", sc.ContactParams(
        penalty_kp=kp, penalty_kv=kv, mu_viscous=0.0))
    b.stab_max_iters = 0
    return b


def build_point_chain(sc):
    """`tests/test_bilateral.py::test_two_body_chain`: two spheres, the first
    pinned to a disabled anchor, the second hung from it by a point joint."""
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_body("a", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.2),
               pos=np.array([0.0, 0.0, 0.0]))
    b.add_body("anchor", enabled=False)
    b.add_body("c", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.2),
               pos=np.array([1.0, 0.0, 0.0]))
    b.add_point_constraint("a", [0, 0, 0], "anchor", [0, 0, 0])
    b.add_point_constraint("a", [0.5, 0, 0], "c", [-0.5, 0, 0])
    return b


def build_gear_pendulum(sc, ratio=2.0, q0=(0.6, -0.3), qd0=(0.0, 0.4)):
    """A double pendulum (two 1 m rods of 1 kg on revolute joints about z,
    gravity along -y) whose joints are coupled by a gear:
    qd_l1 − ratio·qd_l2 = 0 (the velocities start off the constraint, so
    the impact handler's λ-correction has work)."""
    mdl = _mdl(sc)

    def link(name, parent_r):
        j = mdl.JointDef(jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=parent_r,
                         axis=np.array([0.0, 0, 1]))
        return mdl.LinkDef(name=name, mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                           inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]),
                           joint=j)

    m = mdl.ArticulatedModel(
        [link("l1", np.zeros(3)), link("l2", np.array([0.0, -1.0, 0.0]))],
        floating=False)
    m.set_parents([-1, 0])
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("gp", m, q0=np.array(q0), qd0=np.array(qd0))
    b.add_gear_constraint("gp", "l1", "l2", ratio)
    return b


def build_planar_box(sc):
    """A box held in the x-z plane by a planar joint to the disabled ground
    (normal along y, given in the ground's frame), spinning about x and
    sliding as it drops onto the ground plane: the spin and the y motion
    are removed and the box lands in-plane."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("box", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
               pos=np.array([0.0, 0.5, 0.2005]), lin_vel=np.array([0.5, 0.1, -0.3]),
               ang_vel=np.array([3.0, 0.0, 0.0]))
    b.add_geom("box", sc.BOX, [0.2, 0.2, 0.2])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "box", sc.ContactParams(mu_coulomb=0.4, nk=4))
    b.add_planar_constraint("box", "ground", [0.0, 1.0, 0.0])
    return b


def build_sphere_chain(sc, n=6, r=0.2, height=1.5):
    """`n` spheres of radius r laid out along +x from a disabled anchor at
    height `height`, each joined to the next (and the first to the anchor)
    by a point constraint, free to swing down onto the plane: bilateral
    rows and contact in one impact problem. Neighbours' contact pairs are
    disabled (they touch at their joint)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("anchor", enabled=False, pos=np.array([0.0, 0.0, height]))
    names = [f"c{i}" for i in range(n)]
    for i, nm in enumerate(names):
        b.add_body(nm, mass=0.5, inertia=sc.sphere_inertia(0.5, r),
                   pos=np.array([(2 * i + 1) * r, 0.0, height]))
        b.add_geom(nm, sc.SPHERE, [r])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    prev, prev_anchor = "anchor", [0.0, 0.0, 0.0]
    for i, nm in enumerate(names):
        b.set_contact_params("ground", nm, cp)
        for other in names[i + 1:]:
            b.set_contact_params(nm, other, cp)
        b.add_point_constraint(prev, prev_anchor, nm, [-r, 0.0, 0.0])
        if i:
            b.disabled_pairs.add(tuple(sorted((prev, nm))))
        prev, prev_anchor = nm, [r, 0.0, 0.0]
    return b


def jittered_pair(jscene, jstate, B, seed, dz=0.0, dv=0.0, dw=0.0, dqd=0.0):
    """B scenarios of a compiled JAX state and the same B in the port
    (float64, CPU): numpy-made height, velocity, spin and joint-rate
    jitter of scales dz, dv, dw, dqd on the enabled bodies."""
    rng = np.random.default_rng(seed)
    jb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate)
    en = np.asarray(jscene.enabled)[None, :, None]
    nb, nv = jscene.nb, jscene.nv_art
    pos = np.asarray(jb.pos).copy()
    pos[..., 2:] += en[..., :1] * rng.uniform(size=(B, nb, 1)) * dz
    vel = np.asarray(jb.vel) + en * rng.normal(size=(B, nb, 3)) * dv
    omega = np.asarray(jb.omega) + en * rng.normal(size=(B, nb, 3)) * dw
    qd = np.asarray(jb.qd_art) + rng.normal(size=(B, nv)) * dqd
    jb = jb.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    omega=jnp.asarray(omega), qd_art=jnp.asarray(qd))
    return jb, tsc.state_from_arrays(jax_fields(jb), "cpu", torch.float64)


# ---- curved solids on a plane and convex polyhedra, on either package ----

S2 = np.sqrt(0.5)
# local Y -> world x (a cylinder on its side), local Y -> world z (a cone
# base down)
Q_Y_TO_X = np.array([0.0, 0.0, -S2, S2])
Q_Y_TO_Z = np.array([S2, 0.0, 0.0, S2])


def cone_inertia(m, r, h):
    """ConePrimitive::calc_mass_properties (the XML readers' formula)."""
    ix = 0.1 * m * h * h + 3.0 / 20.0 * m * r * r
    return np.diag([ix, m * r * r / 3.0, ix])


def torus_inertia(m, R, r):
    ix = m * (0.5 * R ** 2 + 0.625 * r ** 2)
    return np.diag([ix, ix, m * (R ** 2 + 0.75 * r ** 2)])


def build_curved(sc, lift=2e-4, spin=2.0, mu=0.5):
    """A cylinder (r=0.5, h=1) on its side spinning about its axis, a cone
    (r=0.6, h=1.2) base down and a torus (R=1, r=0.25) lying flat, `lift`
    above one plane (kinds 4, 10 and 5); the pairs between the curved
    bodies are disabled (they are support pairs)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.add_body("cyl", mass=1.0, inertia=sc.cylinder_inertia(1.0, 0.5, 1.0),
               pos=np.array([0.0, 0.0, 0.5 + lift]), quat=Q_Y_TO_X,
               ang_vel=np.array([spin, 0.0, 0.0]))
    b.add_geom("cyl", sc.CYLINDER, [0.5, 1.0])
    b.add_body("cone", mass=1.0, inertia=cone_inertia(1.0, 0.6, 1.2),
               pos=np.array([3.0, 0.0, 0.6 + lift]), quat=Q_Y_TO_Z)
    b.add_geom("cone", sc.CONE, [0.6, 1.2])
    b.add_body("torus", mass=1.0, inertia=torus_inertia(1.0, 1.0, 0.25),
               pos=np.array([-3.5, 0.0, 0.25 + lift]))
    b.add_geom("torus", sc.TORUS, [1.0, 0.25])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=mu, nk=4)
    names = ("cyl", "cone", "torus")
    for i, n in enumerate(names):
        b.set_contact_params("ground", n, cp)
        for m in names[i + 1:]:
            b.disabled_pairs.add(tuple(sorted((n, m))))
    return b


OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                 [0, 0, -1.0]])


def cube_verts(h):
    return np.array([[sx * h, sy * h, sz * h] for sx in (-1, 1)
                     for sy in (-1, 1) for sz in (-1, 1)], np.float64)


def build_octa_on_box(sc, z0=0.6502):
    """`tests/test_gjk.py::test_octahedron_rests_on_box`: an octahedron
    (POLYHEDRON, 0.4 m to its tips) dropped tip down onto a fixed BOX
    platform (kind 9, POLYHEDRON-BOX); at rest its centre is at 0.65 m."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("octa", mass=1.0, inertia=np.eye(3) * 0.05, pos=np.array([0, 0, z0]))
    b.add_geom("octa", sc.POLYHEDRON, [0.0], verts=OCTA * 0.4)
    b.add_body("plat", enabled=False)
    b.add_geom("plat", sc.BOX, [2.0, 2.0, 0.25])
    b.set_contact_params(
        "octa", "plat", sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=4))
    return b


def build_convex(sc, lift=2e-4):
    """Three islands of convex polyhedra, 10 m apart, their mutual pairs
    disabled: the face-down octahedron stack on the plane
    (`tests/test_convex_manifold.py::test_octahedron_stack_rests`; kinds 3
    and 9), an octahedron tip down on a BOX platform (`build_octa_on_box`)
    and a polyhedral cube on a polyhedral slab
    (`test_poly_cube_rests_on_poly_slab`), each `lift` above its rest."""
    n = np.ones(3) / np.sqrt(3.0)
    axis = np.cross(n, [0.0, 0.0, -1.0])
    axis /= np.linalg.norm(axis)
    ang = np.arccos(-n[2])
    q_fd = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])
    r_in = 0.5 / np.sqrt(3.0)
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    for name, z in (("o1", r_in + lift), ("o2", 3 * r_in + 2 * lift)):
        b.add_body(name, mass=1.0, inertia=np.eye(3) * 0.05,
                   pos=np.array([0.0, 0.0, z]), quat=q_fd)
        b.add_geom(name, sc.POLYHEDRON, [0.0], verts=OCTA * 0.5)
    b.add_body("octa", mass=1.0, inertia=np.eye(3) * 0.05,
               pos=np.array([10.0, 0.0, 0.65 + lift]))
    b.add_geom("octa", sc.POLYHEDRON, [0.0], verts=OCTA * 0.4)
    b.add_body("plat", enabled=False, pos=np.array([10.0, 0.0, 0.0]))
    b.add_geom("plat", sc.BOX, [2.0, 2.0, 0.25])
    b.add_body("cube", mass=1.0, inertia=sc.box_inertia(1.0, 0.5, 0.5, 0.5),
               pos=np.array([20.0, 0.0, 1.5 + lift]))
    b.add_geom("cube", sc.POLYHEDRON, [0.0], verts=cube_verts(0.5))
    b.add_body("slab", enabled=False, pos=np.array([20.0, 0.0, 0.0]))
    b.add_geom("slab", sc.POLYHEDRON, [0.0],
               verts=cube_verts(1.0) * np.array([4.0, 4.0, 1.0]))
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    for pair in (("ground", "o1"), ("o1", "o2"), ("cube", "slab")):
        b.set_contact_params(*pair, cp)
    b.set_contact_params(
        "octa", "plat", sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=4))
    islands = (("o1", "o2"), ("octa", "plat"), ("cube", "slab"))
    for i, a in enumerate(islands):
        for c in islands[i + 1:]:
            for x in a:
                for y in c:
                    b.disabled_pairs.add(tuple(sorted((x, y))))
    return b


def assert_same_hulls(tscene, jfields):
    """The port's hull tables equal the JAX package's: the triangles and
    counts exactly, the face-normal and edge-direction sets of every
    geometry as sets of rows."""
    for k in ("geom_faces", "geom_nfaces", "geom_nhn", "geom_nhe"):
        np.testing.assert_array_equal(t2n(getattr(tscene, k)), jfields[k], err_msg=k)
    for k, cnt in (("geom_hull_normals", "geom_nhn"), ("geom_hull_edges", "geom_nhe")):
        t, j = t2n(getattr(tscene, k)), jfields[k]
        assert t.shape == j.shape, k
        for g, c in enumerate(jfields[cnt]):
            ts = {tuple(r) for r in np.round(t[g, :c], 12)}
            js = {tuple(r) for r in np.round(j[g, :c], 12)}
            assert ts == js, (k, g)


# ---- triangle meshes, on either package ----

# the JAX package's mesh tests' polygons (tests/test_trimesh.py): the
# non-convex L and the V-notch channel, in the xz plane
L_POLY = [(0, 0), (2, 0), (2, 1), (1, 1), (1, 2), (0, 2)]
NOTCH_POLY = [(0.0, -0.3), (1.0, 0.5), (1.0, -0.8), (-1.0, -0.8), (-1.0, 0.5)]


def cube_mesh(h=0.5):
    """`tests/test_trimesh.py::cube_mesh`: a cube of half-size h as 12
    outward triangles."""
    v = np.array([
        [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
        [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]])
    f = np.array([
        [0, 2, 1], [0, 3, 2],
        [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4],
        [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5],
        [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


def icosphere(subdiv=2, r=0.5):
    """`tests/test_trimesh_scale.py::icosphere` (20·4^subdiv faces), its
    icosahedron's hull from the port's `geometry.hull` (the same quickhull,
    `native/hull.cpp`, as the JAX package's `native.convex_hull`)."""
    from moby_tpu_torch.geometry import hull

    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            v += [(0, s1, s2 * phi), (s1, s2 * phi, 0), (s2 * phi, 0, s1)]
    v = np.array(v, float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    verts, faces = hull.convex_hull(v)
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = vlist[i] + vlist[j]
                edge_mid[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int32)
    return verts * r, faces


def _axis_quat(axis, ang):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])


def _islands_apart(b, islands, ground=None, on_ground=()):
    """Disable every pair between bodies of different islands, and between
    `ground` and every body but those `on_ground`."""
    for i, a in enumerate(islands):
        for c in islands[i + 1:]:
            for x in a:
                for y in c:
                    b.disabled_pairs.add(tuple(sorted((x, y))))
    if ground is not None:
        for isl in islands:
            for x in isl:
                if x not in on_ground:
                    b.disabled_pairs.add(tuple(sorted((x, ground))))


def build_mesh_kinds(sc, lift=2e-4):
    """One island per mesh pair kind, 10 m apart, each body `lift` above its
    contact: the L-prism on the plane (kind 3), a sphere (r=0.3) in the
    V-notch channel (kind 11, two faces at once; the only sphere-mesh pair,
    as the JAX package's kind 11 takes one pair a group, ROADMAP §3), a mesh
    cube on a BOX platform (kind 12; the BOX added first, so the pair is
    flipped), a BOX on a mesh slab (kind 12, the mesh first) and a BOX over
    an icosphere (subdivided once, kind 12), two mesh cubes stacked on the
    plane (kinds 3 and 13), a mesh cube on a POLYHEDRON slab (kind 13
    through the slab's hull triangles, the slab first) and a POLYHEDRON
    octahedron tip down on a mesh slab (the mesh first). Every body but the
    supports is enabled."""
    from moby_tpu_torch.geometry import trimesh as tm

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    cv, cf = cube_mesh(0.4)
    Jc = tm.mesh_inertia(1.0, cv, cf)[0]
    lv, lf = tm.extrude_polygon(L_POLY, -0.5, 0.5, apex=0)
    Jl, lcom, _ = tm.mesh_inertia(2.0, lv, lf)
    # the L's cross-section stands in the xz plane, its COM lcom[2] up
    b.add_body("L", mass=2.0, inertia=Jl, pos=np.array([0.0, 0.0, lcom[2] + lift]))
    b.add_geom("L", sc.TRIMESH, [0.0], verts=lv - lcom, faces=lf)
    nv, nf = tm.extrude_polygon(NOTCH_POLY, -1.0, 1.0, apex=0)
    b.add_body("channel", enabled=False, pos=np.array([10.0, 0.0, 0.0]))
    b.add_geom("channel", sc.TRIMESH, [0.0], verts=nv, faces=nf)
    zb = 0.3 * np.sqrt(1.0 + 0.8 ** 2) - 0.3
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.3),
               pos=np.array([10.0, 0.0, zb + lift * np.sqrt(1.64)]))
    b.add_geom("ball", sc.SPHERE, [0.3])
    b.add_body("plat", enabled=False, pos=np.array([20.0, 0.0, 0.0]))
    b.add_geom("plat", sc.BOX, [1.0, 1.0, 0.5])
    b.add_body("onplat", mass=1.0, inertia=Jc, pos=np.array([20.0, 0.0, 0.9 + lift]))
    b.add_geom("onplat", sc.TRIMESH, [0.0], verts=cv, faces=cf)
    sv, sf = tm.extrude_polygon([(-2.0, -2.0), (2.0, -2.0), (2.0, 2.0), (-2.0, 2.0)],
                                -0.25, 0.25)
    q_slab = _axis_quat([1, 0, 0], np.pi / 2)     # the extrusion axis y to z
    b.add_body("mslab", enabled=False, pos=np.array([30.0, 0.0, 0.25]), quat=q_slab)
    b.add_geom("mslab", sc.TRIMESH, [0.0], verts=sv, faces=sf)
    b.add_body("boxon", mass=1.0, inertia=sc.box_inertia(1.0, 0.3, 0.2, 0.1),
               pos=np.array([30.0, 0.0, 0.6 + lift]))
    b.add_geom("boxon", sc.BOX, [0.3, 0.2, 0.1])
    b.add_body("m1", mass=1.0, inertia=Jc, pos=np.array([40.0, 0.0, 0.4 + lift]))
    b.add_geom("m1", sc.TRIMESH, [0.0], verts=cv, faces=cf)
    b.add_body("m2", mass=1.0, inertia=Jc, pos=np.array([40.0, 0.0, 1.2 + 2 * lift]))
    b.add_geom("m2", sc.TRIMESH, [0.0], verts=cv, faces=cf)
    b.add_body("pslab", enabled=False, pos=np.array([50.0, 0.0, 0.2]))
    b.add_geom("pslab", sc.POLYHEDRON, [0.0], verts=cube_verts(1.0) * np.array([1.0, 1.0, 0.2]))
    b.add_body("onpoly", mass=1.0, inertia=Jc, pos=np.array([50.0, 0.0, 0.8 + lift]))
    b.add_geom("onpoly", sc.TRIMESH, [0.0], verts=cv, faces=cf)
    b.add_body("mslab2", enabled=False, pos=np.array([60.0, 0.0, 0.25]), quat=q_slab)
    b.add_geom("mslab2", sc.TRIMESH, [0.0], verts=sv, faces=sf)
    b.add_body("octa", mass=1.0, inertia=np.eye(3) * 0.05,
               pos=np.array([60.0, 0.0, 0.9 + lift]))
    b.add_geom("octa", sc.POLYHEDRON, [0.0], verts=OCTA * 0.4)
    iv, if_ = icosphere(1, 0.5)
    b.add_body("ico", enabled=False, pos=np.array([70.0, 0.0, 0.5]))
    b.add_geom("ico", sc.TRIMESH, [0.0], verts=iv, faces=if_)
    b.add_body("boxico", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
               pos=np.array([70.0, 0.0, 1.2 + lift]))
    b.add_geom("boxico", sc.BOX, [0.2, 0.2, 0.2])
    pairs = [("ground", "L"), ("channel", "ball"), ("plat", "onplat"),
             ("mslab", "boxon"), ("ground", "m1"), ("m1", "m2"),
             ("pslab", "onpoly"), ("mslab2", "octa"), ("ico", "boxico")]
    _islands_apart(b, [["L"], ["channel", "ball"], ["plat", "onplat"],
                       ["mslab", "boxon"], ["m1", "m2"], ["pslab", "onpoly"],
                       ["mslab2", "octa"], ["ico", "boxico"]],
                   ground="ground", on_ground=("L", "m1"))
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    for a, c in pairs:
        b.set_contact_params(a, c, cp)
    return b


def _tonne_mesh(b, sc, name, verts, faces, pos):
    """A 1 t mesh body (as `chip_smoke.py`'s mesh configurations)."""
    from moby_tpu_torch.geometry import trimesh as tm

    J = tm.mesh_inertia(1000.0, verts, faces)[0]
    b.add_body(name, mass=1000.0, inertia=J, pos=np.asarray(pos, float))
    b.add_geom(name, sc.TRIMESH, [0.0], verts=verts, faces=faces)


def build_l_and_notch(sc):
    """`chip_smoke.py`'s "meshes": the L-prism resting on the plane (kind 3)
    and, 10 m away, a sphere (r=0.3) resting in the V-notch channel (kind
    11, two faces at once), 1 t each."""
    from moby_tpu_torch.geometry import trimesh as tm

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    lv, lf = tm.extrude_polygon(L_POLY, -0.5, 0.5, apex=0)
    com = tm.mesh_inertia(1000.0, lv, lf)[1]
    _tonne_mesh(b, sc, "L", lv - com, lf, [0.0, 0.0, com[2]])
    nv, nf = tm.extrude_polygon(NOTCH_POLY, -1.0, 1.0, apex=0)
    b.add_body("channel", enabled=False, pos=np.array([10.0, 0.0, 0.0]))
    b.add_geom("channel", sc.TRIMESH, [0.0], verts=nv, faces=nf)
    b.add_body("ball", mass=1000.0, inertia=sc.sphere_inertia(1000.0, 0.3),
               pos=np.array([10.0, 0.0, 0.3 * np.sqrt(1.64) - 0.3]))
    b.add_geom("ball", sc.SPHERE, [0.3])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    b.set_contact_params("ground", "L", cp)
    b.set_contact_params("channel", "ball", cp)
    _islands_apart(b, [["ground", "L"], ["channel", "ball"]])
    return b


def build_mesh_on_box(sc):
    """`chip_smoke.py`'s "meshplatforms": a 1 t mesh cube (half-size 0.4)
    resting on a BOX platform (kind 12)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("box", enabled=False)
    b.add_geom("box", sc.BOX, [1.0, 1.0, 0.5])
    v, f = cube_mesh(0.4)
    _tonne_mesh(b, sc, "mesh", v, f, [0.0, 0.0, 0.9])
    b.set_contact_params("box", "mesh", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5))
    return b
