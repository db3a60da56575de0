"""PyTorch port: the triangle meshes (`moby_tpu_torch.geometry.trimesh` and
the narrow-phase kinds 3 with a mesh, 11, 12 and 13) against the JAX
package, float64 on the CPU.

Point-triangle functions are held to 1e-12, the narrow phase to 1e-10 and
whole steps to L∞ 1e-9. JAX references are jitted once per module
(module-scoped fixtures); the whole steps compile two JAX steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.geometry import trimesh as jtm
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.geometry import trimesh as ttm
from moby_tpu_torch.sim import stepper as tstep
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    L_POLY, NOTCH_POLY, build_l_and_notch, build_mesh_kinds, build_mesh_on_box,
    icosphere, jittered_pair, t2n, torch_scene_state,
)


def _close(t, j, tol, what):
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=0, atol=tol, err_msg=what)


def _voronoi_points():
    """Query points and triangles: for the unit right triangle a=(0,0,0),
    b=(1,0,0), c=(0,1,0), points off its plane in each of the seven regions
    (the vertices a, b, c, the edges ab, ac, bc, the interior) and on their
    borders; then zero-area triangles (collinear, two and three coincident
    vertices); then random triangles and points."""
    tri = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    xy = [(-0.5, -0.5), (1.5, -0.2), (-0.2, 1.5), (0.5, -0.5), (-0.5, 0.5),
          (0.8, 0.8), (0.2, 0.3), (0.0, 0.0), (1.0, 0.0), (0.5, 0.5), (0.0, -0.5),
          (1.2, 0.0)]
    pts, tris = [], []
    for z in (0.3, -0.7, 0.0):
        for x, y in xy:
            pts.append((x, y, z))
            tris.append(tri)
    for deg in ([[0, 0, 0], [1, 1, 1], [2, 2, 2]], [[0, 0, 0], [0, 0, 0], [1, 0, 0]],
                [[0.5, 0.5, 0.5]] * 3):
        for p in ([0.3, -0.4, 0.9], [1.5, 1.5, 1.5], [-1.0, 0.2, 0.0]):
            pts.append(p)
            tris.append(np.array(deg, float))
    rng = np.random.default_rng(11)
    pts = np.concatenate([np.array(pts, float), rng.normal(size=(400, 3)) * 1.5])
    tris = np.concatenate([np.array(tris), rng.normal(size=(400, 3, 3))])
    return pts, tris


def test_closest_point_triangle_matches_jax():
    pts, tris = _voronoi_points()
    jq = jax.jit(jtm.closest_point_triangle)(*(jnp.asarray(x) for x in (
        pts, tris[:, 0], tris[:, 1], tris[:, 2])))
    t = torch.tensor(tris)
    tq = ttm.closest_point_triangle(torch.tensor(pts), t[:, 0], t[:, 1], t[:, 2])
    _close(tq, jq, 1e-12, "q")
    q = t2n(tq)
    # the seven regions of the unit triangle at z = 0.3 (first 7 points)
    np.testing.assert_allclose(q[:7], [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.5, 0, 0],
                                       [0, 0.5, 0], [0.5, 0.5, 0], [0.2, 0.3, 0]],
                               atol=1e-15)


@pytest.fixture(scope="module")
def ico_mesh():
    v, f = icosphere(2, 0.5)
    assert len(f) > ttm.FACE_CHUNK
    return v, f


def test_points_vs_mesh_tiled_matches_jax_and_untiled(ico_mesh, monkeypatch):
    """The 320-face icosphere (F > FACE_CHUNK: the face-tiled loop) against
    the JAX package's scan, points inside, outside and on its vertices; the
    port's tiled result equal to its single block's (as
    tests/test_trimesh_scale.py:100 holds the JAX package's)."""
    verts, faces = ico_mesh
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(2, 60, 3)) * 0.6,
                          np.repeat(verts[None, :4] * 1.0, 2, axis=0)], axis=1)
    vw = np.repeat(verts[None], 2, axis=0) + [[[0.0, 0, 0]], [[0.05, -0.02, 0.01]]]
    fv = np.ones((2, len(faces)), bool)
    fv[1, -3:] = False
    F = np.repeat(faces[None], 2, axis=0)
    jtv = jtm.gather_triangles(jnp.asarray(vw), jnp.asarray(F))
    js, jq, jn = jax.jit(jtm.points_vs_mesh)(jnp.asarray(pts), jtv, jnp.asarray(fv))
    ttv = ttm.gather_triangles(torch.tensor(vw), torch.tensor(F, dtype=torch.int64))
    _close(ttv, jtv, 0.0, "tv")
    out = ttm.points_vs_mesh(torch.tensor(pts), ttv, torch.tensor(fv))
    for t, j, what in zip(out, (js, jq, jn), ("sdist", "q", "n")):
        _close(t, j, 1e-12, what)
    sd = t2n(out[0])
    assert (sd < 0).any() and (sd > 0).any()
    monkeypatch.setattr(ttm, "FACE_CHUNK", len(faces))     # one block of every face
    whole = ttm.points_vs_mesh(torch.tensor(pts), ttv, torch.tensor(fv))
    for t, w in zip(out, whole):
        np.testing.assert_array_equal(t2n(t), t2n(w))


@pytest.mark.parametrize("poly,apex", [
    ([(-2.0, -2.0), (2.0, -2.0), (2.0, 2.0), (-2.0, 2.0)], 0),   # convex
    (L_POLY, 0),
    (NOTCH_POLY, 0),
    (L_POLY[::-1], 5),                        # clockwise: rewound
    (L_POLY, 1),                              # not star-shaped from (2, 0)
])
def test_extrude_polygon_matches_jax(poly, apex):
    """Identical vertices and faces. A polygon that is not star-shaped from
    its apex gives overlapping cap triangles and no error in both packages:
    the volume check refuses only a non-positive volume."""
    jv, jf = jtm.extrude_polygon(poly, -0.5, 0.5, apex=apex)
    tv, tf = ttm.extrude_polygon(poly, -0.5, 0.5, apex=apex)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == np.int32


@pytest.mark.parametrize("poly", [[(0, 0), (1, 1), (1, 0), (0, 1)],   # a bowtie
                                  [(0, 0), (1, 0), (2, 0)]])            # collinear
def test_extrude_polygon_refuses_as_jax(poly):
    with np.errstate(all="ignore"):
        with pytest.raises(ValueError, match="non-positive volume") as jerr:
            jtm.extrude_polygon(poly, -1.0, 1.0)
        with pytest.raises(ValueError, match="non-positive volume") as terr:
            ttm.extrude_polygon(poly, -1.0, 1.0)
    assert str(terr.value) == str(jerr.value)


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _rot_between(u, v):
    """Unit quaternion (xyzw) turning unit vector u onto unit vector v."""
    axis = np.cross(u, v)
    s = np.linalg.norm(axis)
    ang = np.arctan2(s, np.dot(u, v))
    return np.concatenate([axis / s * np.sin(ang / 2), [np.cos(ang / 2)]])


@pytest.fixture(scope="module")
def mesh_kinds():
    """The mesh-kinds scene compiled by the JAX package and carried across,
    and its jitted, batched `narrow_phase` (tol traced)."""
    jscene, jstate = build_mesh_kinds(jsc).compile()
    tscene, _ = torch_scene_state(jscene, jstate)
    fn = jax.jit(jax.vmap(lambda p, q, tol: jnph.narrow_phase(jscene, p, q, tol),
                          in_axes=(0, 0, None)))
    return jscene, jstate, tscene, fn


def _body(jscene, name):
    return list(jscene.body_names).index(name)


def _mesh_poses(jscene, jstate, seed, B=6):
    """B poses of the mesh-kinds scene. Member 0 as built (every body 0.2 mm
    above its contact). Member 1 at the ties: the sphere touching the
    channel's right slope over the diagonal its two triangles share, the
    BOX's corner touching a six-face vertex of the icosphere along its
    radius, the stack's cubes resting exactly. Member 2 as 1 with the
    sphere 1 mm off the slope and the corner 1 mm off the vertex. The rest:
    random tilts up to 0.4 rad and moves up to 5 cm about contact."""
    rng = np.random.default_rng(seed)
    pos = np.repeat(np.asarray(jstate.pos)[None], B, axis=0)
    quat = np.repeat(np.asarray(jstate.quat)[None], B, axis=0)
    g = {n: i for i, n in enumerate(jscene.body_names)}
    # the channel's right slope: the quad over the polygon edge (0,-0.3) ->
    # (1, 0.5), the two triangles sharing its diagonal
    gv = np.asarray(jscene.geom_verts)
    gf = np.asarray(jscene.geom_faces)
    gslot = np.asarray(jscene.geom_slot)
    ch = int(np.flatnonzero(gslot == g["channel"])[0])
    nv = int(np.asarray(jscene.geom_nverts)[ch])
    v = gv[ch, :nv] + pos[0, g["channel"]]
    n = np.array([-0.8, 0.0, 1.0]) / np.sqrt(1.64)
    on_slope = [f for f in gf[ch] if np.allclose((v[f] - v[f[0]]) @ n, 0)
                and np.allclose(v[f][:, 2].min(), -0.3) and v[f][:, 0].max() > 0.5]
    shared = sorted(set(on_slope[0]) & set(on_slope[1]))
    mid = v[shared].mean(axis=0)
    # the icosphere's highest six-face vertex, along its radius
    ic = int(np.flatnonzero(gslot == g["ico"])[0])
    iv = gv[ic, :int(np.asarray(jscene.geom_nverts)[ic])]
    nf = int(np.asarray(jscene.geom_nfaces)[ic])
    valence = np.bincount(gf[ic, :nf].ravel(), minlength=len(iv))
    k = max(np.flatnonzero(valence == 6), key=lambda i: iv[i, 2])
    u = iv[k] / np.linalg.norm(iv[k])
    q_box = _rot_between(np.ones(3) / np.sqrt(3.0), u)
    for i, off in ((1, 0.0), (2, 1e-3)):
        pos[i, g["ball"]] = mid + n * (0.3 + off)
        quat[i, g["boxico"]] = q_box
        pos[i, g["boxico"]] = pos[0, g["ico"]] + iv[k] + u * (off + 0.2 * np.sqrt(3.0))
        pos[i, g["m1"], 2] = 0.4
        pos[i, g["m2"], 2] = 1.2
    en = np.asarray(jscene.enabled)
    for i in range(3, B):
        for j in np.flatnonzero(en):
            dq = rng.normal(size=3)
            dq = np.concatenate([dq / np.linalg.norm(dq) * np.sin(rng.uniform(0, 0.2)),
                                 [0.0]])
            dq[3] = np.sqrt(1.0 - dq[:3] @ dq[:3])
            quat[i, j] = _qmul(dq, quat[i, j])
            pos[i, j] += rng.uniform(-0.05, 0.05, size=3)
    return pos, quat


def test_mesh_narrow_phase_matches_jax(mesh_kinds):
    """Kinds 3 (the L and a mesh cube on the plane), 11, 12 (both builder
    orders, and a BOX corner on a six-face vertex) and 13 (mesh-mesh and
    mesh-polyhedron in both orders) at seeded poses and two contact
    tolerances: `dist`, `pa`, `pb` and `active` everywhere, `point`,
    `normal` and `depth` on active slots, to 1e-10. The ties of member 1
    (two triangles' shared diagonal, six faces' shared vertex, faces
    resting on faces) are decided as in the JAX package."""
    jscene, jstate, tscene, fn = mesh_kinds
    assert set(tscene.kind_groups) == {(3, 16), (11, 4), (12, 24), (13, 8)}
    pos, quat = _mesh_poses(jscene, jstate, 3)
    for ctol in (1e-6, 0.05):
        pdj, cj = fn(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(ctol))
        pdt, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), ctol)
        for f in ("dist", "pa", "pb"):
            _close(getattr(pdt, f), getattr(pdj, f), 1e-10, f)
        act = t2n(ct.active)
        np.testing.assert_array_equal(act, np.asarray(cj.active))
        for f in ("point", "normal", "depth"):
            np.testing.assert_allclose(t2n(getattr(ct, f))[act],
                                       np.asarray(getattr(cj, f))[act],
                                       rtol=0, atol=1e-10, err_msg=f)
        if ctol == 1e-6:
            # member 1 touches: the sphere on one slope face, the corner on
            # the vertex, the cubes' faces on the plane and on each other
            # the diagonal's two triangles give one contact (the second is a
            # duplicate point); the channel's right wall, among the four
            # nearest faces and facing away, gives a deep contact in both
            # packages (ROADMAP §3); 1 mm off, the pair is apart (its distance
            # is slot 0's) and no slot is active
            kinds = t2n(tscene.pair_kind)[t2n(tscene.slot_pair)]
            assert act[1][kinds == 11].tolist() == [True, False, True, False]
            assert not act[2][kinds == 11].any()
            np.testing.assert_allclose(t2n(ct.depth)[1][kinds == 11][2], -0.3 - 0.687, atol=1e-3)
            assert act[1][kinds == 13].sum() >= 4
        else:
            assert act[0].sum() > 20
    dist = t2n(pdt.dist)
    np.testing.assert_allclose(dist[0], 2e-4, atol=1e-9)
    assert (dist[3:] < -1e-3).any() and (dist[3:] > 1e-3).any()


# (builder, steps, linear and angular velocity jitter)
STEPS = {"l_and_notch": (build_l_and_notch, 12, 0.0, 0.0),
         "mesh_on_box": (build_mesh_on_box, 12, 0.05, 0.2)}


@pytest.mark.parametrize("name", list(STEPS))
def test_mesh_step_trajectory_matches_jax(name):
    """Whole steps from the port's own compile against `jax.jit(step)` (one
    compile per scene), B=2 with numpy-made jitter: the L-prism sliding on
    the plane beside the sphere rolling in the V-notch (kinds 3 and 11),
    and the spinning mesh cube landing corner first on the BOX platform
    (kind 12). Positions, orientations and velocities within L∞ 1e-9.
    (Two identical mesh cubes stacked square, `chip_smoke.py`'s meshstack,
    are not held here: their corners coincide, the closest face of a corner
    is decided by rounding, and the two packages' stabilization LCPs part at
    1e-5 in the first step, ROADMAP §3.)"""
    build, n_steps, dv, dw = STEPS[name]
    jscene, jstate = build(jsc).compile()
    tscene, _ = build(tsc).compile(device="cpu")
    jst, tst = jittered_pair(jscene, jstate, 2, seed=7, dz=2e-4, dv=dv, dw=dw)
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
    assert err <= 1e-9, err
    assert pivots > 0                      # the bodies landed: impacts solved
    assert np.isfinite(t2n(tst.pos)).all()


def _cube_on_slab(sc):
    """A mesh cube (half-size 0.4) over a POLYHEDRON slab (kind 13 through
    the slab's hull triangles), 10 m out along x."""
    from test_torch_helpers import cube_mesh, cube_verts

    b = sc.SceneBuilder()
    b.add_body("slab", enabled=False, pos=np.array([10.0, 0.0, 0.2]))
    b.add_geom("slab", sc.POLYHEDRON, [0.0], verts=cube_verts(1.0) * np.array([1.0, 1.0, 0.2]))
    v, f = cube_mesh(0.4)
    b.add_body("cube", mass=1.0, inertia=np.eye(3), pos=np.array([10.0, 0.0, 0.8]))
    b.add_geom("cube", sc.TRIMESH, [0.0], verts=v, faces=f)
    return b


def _both_dtypes(build, pos_of):
    """The narrow phase of the JAX package (jitted) and of the port at the
    poses `pos_of(pos)` makes, in float32 and float64, tol 1e-3."""
    out = {}
    for jdt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        b = build(jsc)
        b.dtype = jdt
        jscene, jstate = b.compile()
        tscene, _ = torch_scene_state(jscene, jstate, tdt)
        pos = pos_of(np.asarray(jstate.pos)).astype(jdt)
        quat = np.repeat(np.asarray(jstate.quat)[None], len(pos), axis=0)
        _, cj = jax.jit(jax.vmap(lambda p, q: jnph.narrow_phase(jscene, p, q, 1e-3)))(
            jnp.asarray(pos), jnp.asarray(quat))
        _, ct = tnph.narrow_phase(tscene, torch.tensor(pos), torch.tensor(quat), 1e-3)
        out[jdt] = (cj, ct)
    return out


def test_float32_mesh_deviations_keep_float64():
    """The two float32 deviations of the mesh kinds (ROADMAP §3), with the
    float64 results those of the JAX package. (1) A BOX platform's top
    corners beside a mesh cube resting on it lie in the plane of the cube's
    bottom face: in float32 rounding signs them inside, and the JAX package
    reads each as a contact 0.85 m deep (its float32 run then lifts the cube
    0.85 m in one step); the port reads a point within NEAR_ZERO rad of its
    face's plane as outside. (2) A mesh vertex 0.36 µm above a polyhedron
    slab: the separation's direction is rounding in float32 (the JAX
    package's normal tilts by up to 10°); below 2.3e-5 m the port takes the
    face normal, as float64 does below 1e-9 m."""
    z0 = np.float32(0.9)
    zs = [np.nextafter(z0, np.float32(0)), z0, np.nextafter(z0, np.float32(2))]

    def on_box(p):
        p = np.repeat(p[None], 3, axis=0)
        p[:, 1, 2] = zs
        return p

    out = _both_dtypes(build_mesh_on_box, on_box)
    cj, ct = out[np.float32]
    corners = np.arange(8, 16)                 # the BOX's corners against the mesh
    assert (np.asarray(cj.active)[:, corners].any(axis=1) & (
        np.asarray(cj.depth)[:, corners].min(axis=1) < -0.8))[:2].all()
    assert not t2n(ct.active)[:, corners].any()
    assert t2n(ct.active)[:, :4].all()

    def on_slab(p):
        p = np.repeat(p[None], 2, axis=0)
        p[:, 1, 2] = 0.8 + 3.6e-7
        p[1, 1, :2] += [0.13, -0.07]
        return p

    out2 = _both_dtypes(_cube_on_slab, on_slab)
    cj, ct = out2[np.float32]
    act = t2n(ct.active)
    assert act.sum() >= 8
    np.testing.assert_allclose(np.abs(t2n(ct.normal)[act]), [[0.0, 0.0, 1.0]] * act.sum(),
                               atol=1e-6)
    jn = np.abs(np.asarray(cj.normal)[np.asarray(cj.active)])
    assert np.abs(jn - [0.0, 0.0, 1.0]).max() > 1e-2
    for res in (out, out2):
        cj, ct = res[np.float64]
        act = t2n(ct.active)
        np.testing.assert_array_equal(act, np.asarray(cj.active))
        for f in ("point", "normal", "depth"):
            np.testing.assert_allclose(t2n(getattr(ct, f))[act],
                                       np.asarray(getattr(cj, f))[act], rtol=0, atol=1e-10)
