"""PyTorch port: the curved solids on a plane (cylinder, cone and torus:
narrow-phase kinds 4, 10 and 5), convex polyhedra (kinds 3 and 9: GJK with
the exact and the sampled MTV) and the GJK functions
(`moby_tpu_torch.geometry.gjk`) against the JAX package, float64 on the CPU.

Closed-form kinds are held to 1e-10, GJK and the MTV to 1e-9, whole-step
trajectories to L∞ 1e-8. Each JAX reference is jitted once per module, in
module-scoped fixtures; the whole steps compile two JAX steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.core.scene import box_vertices
from moby_tpu.geometry import gjk as jgjk
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.geometry import gjk as tgjk
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.math import linalg as tlinalg
from moby_tpu_torch.sim import stepper as tstep
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    Q_Y_TO_Z, build_convex, build_curved, build_octa_on_box, cube_verts,
    jittered_pair, t2n, torch_scene_state,
)

B = 6


def _close(t, j, tol, what):
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0, atol=tol, err_msg=what)


def _axis_angle(axis, ang):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _curved_poses(jstate, seed):
    """B poses of the curved scene (ground, cylinder, cone, torus): member 0
    as built (the cylinder's side, the cone's base and the torus's ring
    resting: the 2- and 4-contact cases), member 1 the cylinder upright on
    an end cap, the cone on its slant and the torus tilted, the rest
    random tilts and heights about contact."""
    rng = np.random.default_rng(seed)
    pos = np.repeat(np.asarray(jstate.pos)[None], B, axis=0)
    quat = np.repeat(np.asarray(jstate.quat)[None], B, axis=0)
    half = np.arctan2(0.6, 1.2)
    tilt = np.pi / 2 - half
    quat[1, 1] = Q_Y_TO_Z
    quat[1, 2] = _qmul(_axis_angle([0, 1, 0], tilt), Q_Y_TO_Z)
    quat[1, 3] = _axis_angle([1, 0, 0], 0.3)
    for i in range(2, B):
        for k in (1, 2, 3):
            dq = _axis_angle(rng.normal(size=3), rng.uniform(0.0, 0.6))
            quat[i, k] = _qmul(dq, quat[i, k])
    pos[1:, 1:, 2] += rng.uniform(-0.05, 0.05, size=(B - 1, 3))
    return pos, quat


def _convex_poses(jstate, seed, spread=0.08):
    """B poses of `build_convex` (or its first island) around its resting
    layout: member 0 as built, the others tilted and moved by up to `spread`
    (some pairs penetrate, some separate)."""
    rng = np.random.default_rng(seed)
    pos = np.repeat(np.asarray(jstate.pos)[None], B, axis=0)
    quat = np.repeat(np.asarray(jstate.quat)[None], B, axis=0)
    for i in range(1, B):
        for k in range(1, pos.shape[1]):
            if k not in (4, 6):   # the ground, the platform and slab stay put
                quat[i, k] = _qmul(_axis_angle(rng.normal(size=3),
                                               rng.uniform(0.0, 0.5)), quat[i, k])
                pos[i, k] += rng.uniform(-spread, spread, size=3)
    return pos, quat


@pytest.fixture(scope="module")
def jax_narrow():
    """`jax.vmap(narrow_phase)`, jitted once per scene (tol traced)."""
    fns = {}

    def get(key, jscene):
        if key not in fns:
            fns[key] = jax.jit(jax.vmap(
                lambda p, q, tol: jnph.narrow_phase(jscene, p, q, tol),
                in_axes=(0, 0, None)))
        return fns[key]

    return get


def _scenes():
    jc, jcs = build_curved(jsc).compile()
    jv, jvs = build_convex(jsc).compile()
    # the convex scene's first island (the octahedron stack on the plane)
    # without hull tables: the sampled-MTV branch
    b = build_convex(jsc)
    b.bodies = b.bodies[:3]
    b.geoms = b.geoms[:3]
    jn, jns = b.compile()
    jn = jn.replace(geom_nhn=jnp.zeros_like(jn.geom_nhn))
    return {"curved": (jc, jcs), "convex": (jv, jvs), "convex_sampled": (jn, jns)}


SCENES = _scenes()


@pytest.mark.parametrize("name,tol", [
    ("curved", 1e-10), ("convex", 1e-9), ("convex_sampled", 1e-9)])
def test_narrow_phase_matches_jax(jax_narrow, name, tol):
    """`dist`, `pa`, `pb` and `active` everywhere and `point`, `normal` and
    `depth` on active slots, at the contact tolerance of the CA loop and a
    wide one: kinds 4, 5 and 10 (every case: the 4-, 2- and 1-contact
    branches), and kinds 3 and 9 through the exact and the sampled MTV."""
    jscene, jstate = SCENES[name]
    tscene, _ = torch_scene_state(jscene, jstate)
    kinds = {k for k, _ in tscene.kind_groups}
    if name == "curved":
        assert kinds == {tsc.K_CYLINDER_PLANE, tsc.K_CONE_PLANE, tsc.K_TORUS_PLANE}
        pos, quat = _curved_poses(jstate, 1)
    else:
        assert kinds == {tsc.K_PLANE_GENERIC, tsc.K_CONVEX_CONVEX}
        assert (int(tscene.host["geom_nhn"].max()) > 0) == (name == "convex")
        pos, quat = _convex_poses(jstate, 2)
    fn = jax_narrow(name, jscene)
    for ctol in (1e-6, 0.05):
        pdj, cj = fn(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(ctol))
        pdt, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), ctol)
        for f in ("dist", "pa", "pb"):
            _close(getattr(pdt, f), getattr(pdj, f), tol, f)
        act = t2n(ct.active)
        np.testing.assert_array_equal(act, np.asarray(cj.active))
        assert act.any()
        for f in ("point", "normal", "depth"):
            np.testing.assert_allclose(t2n(getattr(ct, f))[act],
                                       np.asarray(getattr(cj, f))[act],
                                       rtol=0, atol=tol, err_msg=f)
    dist = t2n(pdt.dist)
    if name == "curved":
        # member 0 as built: the side's 2, the base's 4 and the ring's 4
        # contacts, each body 0.2 mm above the plane
        np.testing.assert_allclose(dist[0], 2e-4, atol=1e-12)
        assert act[0].sum() == 2 + 4 + 4
    else:
        assert (dist < -1e-3).any() and (dist > 1e-3).any()


def _pad(v, n=16):
    out = np.zeros((n, 3))
    out[: len(v)] = v
    return out


# the pairs of tests/test_gjk.py and tests/test_convex_manifold.py, one per
# row: (A's vertices, B's vertices)
_GJK_PAIRS = [
    (box_vertices(1, 1, 1), box_vertices(1, 1, 1) + [5.0, 0, 0]),
    (box_vertices(0.5, 0.5, 0.5), box_vertices(0.5, 0.5, 0.5) + [2.0, 2.0, 0.0]),
    (box_vertices(1, 1, 1), box_vertices(1, 1, 1) + [0.5, 0.0, 0.0]),
    (np.zeros((1, 3)), np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]) + [3.0, 0, 0]),
    (box_vertices(1, 1, 1), box_vertices(1, 1, 1) + [0.0, 4.0, 0.0]),
    (box_vertices(1, 1, 1), box_vertices(1, 1, 1) + [10.0, 0.0, 0.0]),
    (cube_verts(1.0), cube_verts(1.0) + [1.5, 0, 0]),
    (cube_verts(0.5), cube_verts(0.5) + [0.0, 0.0, 0.4]),
]


def _gjk_batch():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(30, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pairs = _GJK_PAIRS + [(pts * 2.0, pts * 0.5 + [1.6, 0, 0.0])]
    va = np.stack([_pad(a, 30) for a, _ in pairs])
    vb = np.stack([_pad(b, 30) for _, b in pairs])
    na = np.array([len(a) for a, _ in pairs])
    nb = np.array([len(b) for _, b in pairs])
    return va, na, vb, nb


def test_gjk_and_mtv_match_jax():
    """`gjk` and the sampled `mtv` on the pairs of the JAX package's GJK and
    manifold tests (separated, touching, overlapping, a point against a
    tetrahedron, a sphere cloud in a larger one), batched."""
    va, na, vb, nb = _gjk_batch()
    J = [jnp.asarray(x) for x in (va, na, vb, nb)]
    T = [torch.tensor(x) for x in (va, na, vb, nb)]
    rj = jax.jit(jax.vmap(jgjk.gjk))(*J)
    rt = tgjk.gjk(*T)
    for f in ("dist", "pa", "pb"):
        _close(getattr(rt, f), getattr(rj, f), 1e-9, f)
    np.testing.assert_array_equal(t2n(rt.intersecting), np.asarray(rj.intersecting))
    np.testing.assert_allclose(t2n(rt.dist)[[0, 1, 3, 4, 5]],
                               [3.0, np.sqrt(2.0), 3.0, 2.0, 8.0], atol=1e-6)
    dj, nj = jax.jit(jax.vmap(jgjk.mtv))(*J)
    dt, nt = tgjk.mtv(*T)
    _close(dt, dj, 1e-9, "mtv depth")
    _close(nt, nj, 1e-9, "mtv normal")
    assert abs(float(dt[6]) - 0.5) < 0.03 and float(nt[6, 0]) < -0.95


def test_mtv_exact_and_mtv_support_match_jax():
    """`mtv_exact` over the hull face normals and edge crosses of two boxes
    in face, deep and edge-edge overlap, and `mtv_support` over a
    closed-form support sum (a sphere against a box) with extra seeds."""
    va = np.stack([cube_verts(0.5)] * 3)
    vb = np.stack([cube_verts(0.5) + [0.88, 0, 0], cube_verts(0.5) + [0, 0, 0.4],
                   cube_verts(0.5) @ np.array([[1, 0, 0], [0, 1, 1], [0, -1, 1]]).T
                   / np.sqrt([1, 2, 2]) + [0.45, 0, 0.5 + np.sqrt(2) / 2 - 0.1]])
    n = np.full(3, 8)
    dirs = np.concatenate([np.eye(3), np.eye(3)])
    ed = np.eye(3)
    cr = np.cross(ed[:, None], ed[None]).reshape(9, 3)
    crn = np.linalg.norm(cr, axis=1)
    cands = np.concatenate([dirs, cr / np.maximum(crn, 1e-30)[:, None]])
    ok = np.concatenate([np.ones(6, bool), crn > 1e-9])
    cands = np.stack([cands] * 3)
    ok = np.stack([ok] * 3)
    dj, nj = jax.jit(jax.vmap(jgjk.mtv_exact))(
        *[jnp.asarray(x) for x in (va, n, vb, n, cands, ok)])
    dt, nt = tgjk.mtv_exact(*[torch.tensor(x) for x in (va, n, vb, n, cands, ok)])
    _close(dt, dj, 1e-9, "depth")
    _close(nt, nj, 1e-9, "normal")
    np.testing.assert_allclose(t2n(dt)[:2], [0.12, 0.6], atol=1e-12)

    c = np.array([[0.3, 0.2, 0.1], [1.0, 0.0, 0.4]])
    half = np.array([0.5, 0.4, 0.3])

    def j_t(d):
        return 0.35 * jnp.linalg.norm(d, axis=-1) + jnp.abs(d) @ jnp.asarray(half)

    def t_t(d):
        return 0.35 * torch.linalg.vector_norm(d, dim=-1) + d.abs() @ torch.tensor(half)

    extra = np.eye(3)[None].repeat(2, 0)
    eok = np.array([[True, True, False], [True, False, True]])

    @jax.jit
    def j_support(ck, ek, okk):
        return jgjk.mtv_support(lambda d: j_t(d) - d @ ck, jnp.float64,
                                extra_dirs=ek, extra_ok=okk)

    for k in range(2):
        dj, nj = j_support(jnp.asarray(c[k]), jnp.asarray(extra[k]), jnp.asarray(eok[k]))
        dt, nt = tgjk.mtv_support(
            lambda d, k=k: t_t(d) - d @ torch.tensor(c[k]), (), torch.float64, "cpu",
            extra_dirs=torch.tensor(extra[k]), extra_ok=torch.tensor(eok[k]))
        _close(dt, dj, 1e-9, "support depth")
        _close(nt, nj, 1e-9, "support normal")


def test_closest_on_simplex_drops_singular_subsets_like_jax():
    """Duplicate and coplanar simplex points make subsets' 5x5 systems
    singular: `jnp.linalg.solve` and the port's `linalg.solve_ex` (LAPACK's
    LU in float64 on the CPU) both return non-finite barycentrics there, so
    both packages drop the same subsets and agree on the closest point, the
    barycentrics and the support."""
    W = np.array([
        [[1.0, 0.2, 0.3], [1.0, 0.2, 0.3], [0.5, -1.0, 0.1], [0.0, 0.0, 0.0]],
        [[1.0, 1.0, 0.5], [-1.0, 1.0, 0.5], [0.0, -1.0, 0.5], [0.3, 0.2, 0.5]],
        [[2.0, 0.0, 0.0], [2.0, 1.0, 0.0], [2.0, 1.0, 0.0], [2.0, 1.0, 0.0]],
        [[1.0, -1.0, 1.0], [1.0, 1.0, 1.0], [0.5, 0.0, -1.0], [1.5, 0.0, -1.0]],
    ])
    active = np.array([[True, True, True, False], [True] * 4, [True] * 4,
                       [True, True, True, False]])
    pj, bj, kj = jax.jit(jax.vmap(jgjk._closest_on_simplex))(
        jnp.asarray(W), jnp.asarray(active))
    pt, bt, kt = tgjk._closest_on_simplex(torch.tensor(W), torch.tensor(active))
    _close(pt, pj, 1e-12, "point")
    np.testing.assert_allclose(t2n(pt)[1:3], [[0.0, 0.0, 0.5], [2.0, 0.0, 0.0]],
                               atol=1e-12)
    # the closest point of member 1 lies inside two triangles of its flat
    # quad, equally close: which one is kept is decided by rounding, so
    # member 1's barycentrics and support are compared only in kind
    unique = [0, 2, 3]
    _close(bt[unique], np.asarray(bj)[unique], 1e-12, "barycentrics")
    np.testing.assert_array_equal(t2n(kt)[unique], np.asarray(kj)[unique])
    assert t2n(kt)[1].sum() == np.asarray(kj)[1].sum() == 3
    # the two duplicates of member 0 are never both in the support
    assert not (t2n(kt)[0, 0] and t2n(kt)[0, 1])

    # the system of member 0's subset {0, 1} and member 1's {0, 1, 2, 3}:
    # singular, non-finite in both packages
    for w, mask in ((W[0], [1, 1, 0, 0]), (W[1], [1, 1, 1, 1])):
        m = np.asarray(mask, bool)
        A = np.zeros((5, 5))
        A[:4, :4] = np.where(m[:, None] & m[None], w @ w.T, 0.0) + np.diag(~m * 1.0)
        A[:4, 4] = A[4, :4] = m
        rhs = np.eye(5)[4]
        sol_j = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(rhs)))
        sol_t = tlinalg.solve_ex(torch.tensor(A), torch.tensor(rhs)[:, None])
        assert not np.isfinite(sol_j[:4][m]).all()
        assert not np.isfinite(t2n(sol_t)[:4, 0][m]).all()


def test_float32_keeps_the_float64_cases():
    """Two deliberate float32 deviations from the JAX package (ROADMAP §3).
    GJK's tolerances are float64 sizes: the JAX package's float32 GJK reads
    the octahedron's tip 0.1 mm into the platform as 0.23 m apart, so the
    port runs GJK and the MTV in float64 for a float32 scene and reports the
    penetration. And 1 - 1e-8 rounds to 1 in float32, so the cylinder's cap
    and the cone's base could never rest flat: the port's float32 takes
    1e-6. Both keep the float64 narrow phase's contacts in float32."""
    jscene, jstate = build_octa_on_box(jsc).compile()
    pos = np.asarray(jstate.pos)[None].copy()
    pos[0, 0, 2] = 0.6499
    quat = np.asarray(jstate.quat)[None]
    out = {}
    for dt in (torch.float64, torch.float32):
        tscene, _ = torch_scene_state(jscene, jstate, dt)
        pd, con = tnph.narrow_phase(tscene, torch.tensor(pos, dtype=dt),
                                    torch.tensor(quat, dtype=dt), 1e-3)
        out[dt] = (t2n(pd.dist)[0, 0], t2n(con.active)[0], t2n(con.depth)[0])
    np.testing.assert_allclose(out[torch.float64][0], -1e-4, atol=1e-12)
    np.testing.assert_allclose(out[torch.float32][0], -1e-4, atol=1e-6)
    np.testing.assert_array_equal(out[torch.float32][1], out[torch.float64][1])
    np.testing.assert_allclose(out[torch.float32][2], out[torch.float64][2], atol=1e-6)
    octa = np.zeros((8, 3), np.float32)
    octa[:6] = np.asarray(jscene.geom_verts)[0, :6] + pos[0, 0]
    box = np.asarray(jscene.geom_verts)[1].astype(np.float32)
    r = jax.jit(jgjk.gjk)(jnp.asarray(octa), 6, jnp.asarray(box), 8)
    assert float(r.dist) > 0.2 and not bool(r.intersecting)

    jc, jcs = SCENES["curved"]
    pos, quat = _curved_poses(jcs, 1)
    act = {}
    for dt in (torch.float64, torch.float32):
        tscene, _ = torch_scene_state(jc, jcs, dt)
        _, con = tnph.narrow_phase(tscene, torch.tensor(pos[:2], dtype=dt),
                                   torch.tensor(quat[:2], dtype=dt), 0.05)
        act[dt] = t2n(con.active)
    np.testing.assert_array_equal(act[torch.float32], act[torch.float64])
    # the upright cylinder's 4 cap points and the cone's 4 base points
    assert act[torch.float32][1, :4].sum() == 4 and act[torch.float32][0, 4:8].sum() == 4


STEPS = {"curved": (build_curved, 8), "octa_on_box": (build_octa_on_box, 10)}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_trajectory_matches_jax(name):
    """Whole steps from the port's own compile against `jax.jit(step)` (one
    compile per scene), B=2 with numpy-made jitter: the spinning cylinder
    on its side, the cone on its base and the torus lying flat land and roll
    (kinds 4, 10, 5); the octahedron lands tip down on the BOX platform
    (kind 9 through `mtv_exact`). Positions, orientations and velocities
    within L∞ 1e-8. Pivot counts are not compared: the cone's and the
    torus's four rim contacts are redundant, so how many block pivots an
    equal LCP takes is decided by rounding (the states agree to 1e-12)."""
    build, n_steps = STEPS[name]
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    jst, tst = jittered_pair(jscene, jstate, 2, seed=7, dz=1e-4, dv=0.05, dw=0.2)
    step = jax.jit(lambda s: jstep.step(jscene, s, 1e-3))
    js = [jax.tree_util.tree_map(lambda x, i=i: x[i], jst) for i in range(2)]
    err, pivots = 0.0, 0
    for _ in range(n_steps):
        js = [step(s) for s in js]
        tst = tstep.step(tscene, tst, 1e-3, device="cpu")
        for f in ("pos", "quat", "vel", "omega", "time"):
            jv = np.stack([np.asarray(getattr(s, f)) for s in js])
            err = max(err, float(np.abs(jv - t2n(getattr(tst, f))).max()))
        pivots += int(t2n(tst.solver_pivots).sum())
    assert err <= 1e-8, err
    assert pivots > 0                      # the bodies landed: impacts solved
    z = t2n(tst.pos)[..., 2]
    if name == "curved":
        # none sank into the plane: cylinder, cone and torus centres at r,
        # H/2 and r above it
        assert (z[:, 1:] > np.array([0.5, 0.6, 0.25]) - 1e-3).all()
    else:
        np.testing.assert_allclose(z[:, 0], 0.65, atol=1e-3)
