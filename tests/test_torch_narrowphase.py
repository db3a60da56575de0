"""PyTorch port: `moby_tpu_torch.geometry.narrowphase` and
`moby_tpu_torch.sim.kinematics` against the JAX package, float64, on scenes
compiled by the JAX package's `SceneBuilder` and carried across with `scene_from_arrays`.
Straight-line code: 1e-12."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.sim import kinematics as jkin
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.sim import kinematics as tkin
from moby_tpu_torch.sim import stepper as tstep
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    build_box_on_box, build_box_on_plane, build_stack, jax_fields, t2n,
    torch_scene_state,
)
from moby_tpu_torch.core import scene as tsc

ATOL = 1e-12
B = 5


def _box_sphere_scene(sc):
    """A box, a sphere beside/inside/above it, and the plane: every ported
    kind (sphere-sphere, sphere-plane, box-sphere, plane-box) has a pair."""
    b = build_box_on_plane(sc)
    b.add_body("ball2", mass=0.5, inertia=sc.sphere_inertia(0.5, 0.2),
               pos=np.array([0.9, 0.0, 0.2]))
    b.add_geom("ball2", sc.SPHERE, [0.2])
    return b


SCENES = {
    "stack": lambda sc: build_stack(sc, nk=4),
    "box_sphere": _box_sphere_scene,
    "box_box": build_box_on_box,
    "box_box_capped": lambda sc: build_box_on_box(sc, max_slots=6),
}


def _perturbed(name, seed):
    """(jscene, tscene, batched numpy pos/quat/vel/omega)."""
    jscene, jstate = SCENES[name](jsc).compile()
    tscene, _ = torch_scene_state(jscene, jstate)
    rng = np.random.default_rng(seed)
    nb = jscene.nb
    pos = np.asarray(jstate.pos)[None] + rng.normal(size=(B, nb, 3)) * 0.05
    pos[0] = np.asarray(jstate.pos)               # one exactly-touching member
    quat = np.asarray(jstate.quat)[None] + rng.normal(size=(B, nb, 4)) * 0.1
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    quat[:, -1] = np.asarray(jstate.quat)[-1]     # the ground stays put
    pos[:, -1] = np.asarray(jstate.pos)[-1]
    vel = rng.normal(size=(B, nb, 3))
    omega = rng.normal(size=(B, nb, 3))
    return jscene, jstate, tscene, pos, quat, vel, omega


@pytest.mark.parametrize("tol", [1e-6, np.inf, 0.05])
@pytest.mark.parametrize("name", list(SCENES))
def test_narrow_phase_matches_jax(name, tol):
    jscene, _, tscene, pos, quat, _, _ = _perturbed(name, 1)
    pdj, cj = jax.vmap(lambda p, q: jnph.narrow_phase(
        jscene, p, q, jnp.asarray(tol)))(jnp.asarray(pos), jnp.asarray(quat))
    pdt, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), tol)
    for f in ("dist", "pa", "pb"):
        np.testing.assert_allclose(t2n(getattr(pdt, f)), np.asarray(getattr(pdj, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    np.testing.assert_array_equal(t2n(ct.active), np.asarray(cj.active))
    assert t2n(ct.active).any()
    for f in ("point", "normal", "depth", "tan1", "tan2"):
        np.testing.assert_allclose(t2n(getattr(ct, f)), np.asarray(getattr(cj, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    for f in ("s1", "s2", "pair"):
        np.testing.assert_array_equal(t2n(getattr(ct, f)), np.asarray(getattr(cj, f))[0])
    pd2 = tnph.pair_distances(tscene, torch.tensor(pos), torch.tensor(quat))
    np.testing.assert_allclose(t2n(pd2.dist), np.asarray(pdj.dist), atol=ATOL, rtol=0)


def test_topk_by_depth_matches_jax():
    """The k smallest valid depths in order, index 0 once none is left."""
    rng = np.random.default_rng(9)
    depth = rng.normal(size=(6, 10))
    depth[1, 3] = depth[1, 7]                    # a tie: the first wins
    valid = rng.uniform(size=(6, 10)) < 0.6
    valid[2] = False
    valid[3, 1:] = False
    ij = jax.vmap(lambda d, v: jnph._topk_by_depth(d, v, 4))(
        jnp.asarray(depth), jnp.asarray(valid))
    it = tnph._topk_by_depth(torch.tensor(depth), torch.tensor(valid), 4)
    np.testing.assert_array_equal(t2n(it), np.asarray(ij))


def test_box_sphere_inside_and_outside():
    """The sphere centre inside the box takes the nearest-face branch."""
    jscene, jstate, tscene, pos, quat, _, _ = _perturbed("box_sphere", 2)
    pos[1, 1] = pos[1, 0] + np.array([0.05, 0.02, 0.01])     # ball inside box
    pdj, cj = jax.vmap(lambda p, q: jnph.narrow_phase(
        jscene, p, q, jnp.asarray(1e-6)))(jnp.asarray(pos), jnp.asarray(quat))
    pdt, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), 1e-6)
    assert t2n(pdt.dist)[1].min() < -0.2
    np.testing.assert_allclose(t2n(pdt.dist), np.asarray(pdj.dist), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(ct.normal), np.asarray(cj.normal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(ct.point), np.asarray(cj.point), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(SCENES))
def test_kinematics_and_ca_bound_match_jax(name):
    jscene, jstate, tscene, pos, quat, vel, omega = _perturbed(name, 3)
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate).replace(
        pos=jnp.asarray(pos), quat=jnp.asarray(quat), vel=jnp.asarray(vel),
        omega=jnp.asarray(omega))
    tst = tsc.state_from_arrays(jax_fields(jst), "cpu", torch.float64)

    ptj = jax.vmap(lambda s: jkin.compute(jscene, s))(jst)
    ptt = tkin.compute(tscene, tst)
    np.testing.assert_array_equal(t2n(ptt.W), np.asarray(ptj.W)[0])
    np.testing.assert_array_equal(
        t2n(tkin.gc_velocity(tscene, tst)),
        np.asarray(jax.vmap(lambda s: jkin.gc_velocity(jscene, s))(jst)))
    dv = np.random.default_rng(4).normal(size=(B, jscene.ngc))
    sj = jax.vmap(lambda s, d: jkin.apply_gc_velocity_delta(jscene, s, d))(
        jst, jnp.asarray(dv))
    stt = tkin.apply_gc_velocity_delta(tscene, tst, torch.tensor(dv))
    np.testing.assert_allclose(t2n(stt.vel), np.asarray(sj.vel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t2n(stt.omega), np.asarray(sj.omega), atol=ATOL, rtol=0)

    caj, mdoj = jax.vmap(lambda s: jstep.ca_euler_step(
        jscene, s, jkin.compute(jscene, s), s.min_dist_obs))(jst)
    cat, mdot = tstep.ca_euler_step(tscene, tst, ptt, tst.min_dist_obs)
    np.testing.assert_allclose(t2n(cat), np.asarray(caj), atol=ATOL, rtol=1e-12)
    np.testing.assert_allclose(t2n(mdot), np.asarray(mdoj), atol=ATOL, rtol=0)

    aj = jax.vmap(lambda s: jstep.forward_dynamics_free(
        jscene, s.quat, s.omega, s.vel))(jst)
    at = tstep.forward_dynamics_free(tscene, tst.quat, tst.omega, tst.vel)
    for t_, j_ in zip(at, aj):
        np.testing.assert_allclose(t2n(t_), np.asarray(j_), atol=ATOL, rtol=0)
    bj = jax.vmap(lambda s: jnph.plane_generic_sweep_bound(
        jscene, jkin.compute(jscene, s), 1e-8))(jst)
    np.testing.assert_array_equal(
        t2n(tnph.plane_generic_sweep_bound(tscene, ptt, 1e-8)), np.asarray(bj))
