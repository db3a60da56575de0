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
    build_box_on_box, build_box_on_plane, build_stack, jax_fields, plane_quat,
    t2n, torch_scene_state,
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


# a NaN with its sign bit set, the x86 default NaN (what inf - inf gives)
_NEG_NAN = np.frombuffer(np.uint64(0xFFF8000000000000).tobytes(), np.float64)[0]


def test_topk_slots_break_ties_as_lax_top_k():
    """`_topk_slots` against the JAX package's (`lax.top_k` of -sdist): equal
    values lower index first, padded inf slots in index order, a -0.0 before
    a 0.0, a NaN with its sign bit set first and one without it last (IEEE
    total order), in float64 and float32. `torch.topk` left ties in no fixed
    order: the first row came out [1 0 3 2 4 5 6 7 30 29 ...]."""
    rows = np.full((5, 40), np.inf)
    rows[0, :8] = [0, 0, 0, 0, 1, 1, 1, 1]
    rows[1, :6] = [0.0, -0.0, 0.0, -0.0, 1.0, -0.0]
    rows[2, :6] = [1.0, np.nan, 0.5, np.inf, np.nan, -1.0]
    rows[3, :6] = [1.0, _NEG_NAN, 0.5, np.inf, _NEG_NAN, -1.0]
    rows[4] = np.round(np.random.default_rng(4).normal(size=40), 1)
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        for k in (4, 16):
            ij, vj = jax.jit(lambda r: jnph._topk_slots(r, k))(jnp.asarray(rows, jdt))
            it, vt = tnph._topk_slots(torch.tensor(rows, dtype=dt), k)
            np.testing.assert_array_equal(t2n(it), np.asarray(ij))
            assert np.array_equal(t2n(vt), np.asarray(vj), equal_nan=True)
            assert np.array_equal(np.signbit(t2n(vt)), np.signbit(np.asarray(vj)))
    assert t2n(it)[0].tolist() == list(range(16))


def _dodecahedron(r):
    phi = (1.0 + 5.0 ** 0.5) / 2.0
    v = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    for a in (-1, 1):
        for b in (-1, 1):
            v += [(0, a / phi, b * phi), (a / phi, b * phi, 0), (a * phi, 0, b / phi)]
    return np.array(v, float) * r / 3.0 ** 0.5


def _flat_box_and_polyhedron(sc):
    """A box resting flat on the plane (its four bottom vertices and its four
    top ones at tied depths) and, apart from it, a 20-vertex POLYHEDRON: its
    vertices raise vmax past VSLOT_CAP, so the box's plane slots are the 16
    deepest of 20, padded inf included (the top-k path of kind 3)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("box", mass=2.0, inertia=sc.box_inertia(2.0, 0.5, 0.4, 0.3),
               pos=np.array([0.0, 0.0, 0.3]))
    b.add_geom("box", sc.BOX, [0.5, 0.4, 0.3])
    b.add_body("dodeca", mass=1.0, inertia=np.eye(3) * 0.1, pos=np.array([4.0, 0.0, 1.0]))
    b.add_geom("dodeca", sc.POLYHEDRON, [0.0], verts=_dodecahedron(0.5))
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.disabled_pairs.add(("box", "dodeca"))
    return b


def test_tied_plane_slots_match_jax_slot_for_slot():
    """The flat box beside a 20-vertex polyhedron: every contact slot equal
    to the JAX package's, in order (on the parent the box's slots 2 and 3
    held JAX's 3 and 2). Member 0 as built, the others moved along the
    plane and turned about its normal, which keeps the ties."""
    jscene, jstate = _flat_box_and_polyhedron(jsc).compile()
    tscene, _ = torch_scene_state(jscene, jstate)
    assert jscene.vmax == 20 and {k for k, _ in tscene.kind_groups} == {3}
    rng = np.random.default_rng(5)
    pos = np.repeat(np.asarray(jstate.pos)[None], 4, axis=0)
    quat = np.repeat(np.asarray(jstate.quat)[None], 4, axis=0)
    pos[1:, 0, :2] += rng.uniform(-1.0, 1.0, size=(3, 2))
    ang = rng.uniform(0.0, np.pi, size=3)
    quat[1:, 0] = np.stack([np.zeros(3), np.zeros(3), np.sin(ang / 2), np.cos(ang / 2)], -1)
    fn = jax.jit(jax.vmap(lambda p, q: jnph.narrow_phase(jscene, p, q, 1e-6)))
    pdj, cj = fn(jnp.asarray(pos), jnp.asarray(quat))
    pdt, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), 1e-6)
    np.testing.assert_array_equal(t2n(ct.active), np.asarray(cj.active))
    assert t2n(ct.active)[:, :16].sum(axis=1).tolist() == [4, 4, 4, 4]
    for f in ("point", "normal", "depth"):
        np.testing.assert_allclose(t2n(getattr(ct, f)), np.asarray(getattr(cj, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    np.testing.assert_allclose(t2n(pdt.dist), np.asarray(pdj.dist), atol=ATOL, rtol=0)


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
