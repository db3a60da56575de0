"""Triangle-mesh geometry (counterpart of ``moby_tpu/geometry/trimesh.py``):
OBJ loading, mass properties, the point-triangle functions of the mesh
contact kinds and polygon extrusion.

The reference's `TriangleMeshPrimitive` (src/TriangleMeshPrimitive.cpp)
walks a BVH; here a mesh is a fixed-shape (VMAX, 3) vertex table and an
(FMAX, 3) face-index table, and every query is a masked reduction over all
faces, tiled over FACE_CHUNK faces at a time above that size. Meshes are
taken as watertight with outward faces (the reference's signed distances,
TriangleMeshPrimitive::calc_signed_dist, assume the same).

`load_obj`, `mesh_mass_properties`, `mesh_inertia` and `extrude_polygon`
are numpy; `closest_point_triangle`, `gather_triangles` and
`points_vs_mesh` are torch, batched over any leading dims. Their sums and
multiply-adds round as the JAX package's jitted CPU code does (`dot3`,
`torch.addcmul`), so that ties between faces and the sign of a point lying
on a face are decided as there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as cfg
from ..math.linalg import dot3


def load_obj(path):
    """Load a Wavefront OBJ as an indexed triangle mesh.

    Returns (verts (V, 3) float64, faces (F, 3) int32). Polygon faces are
    fan-triangulated. (The reference reads meshes through
    `IndexedTriArray::read_from_obj`, src/IndexedTriArray.cpp.)
    """
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def mesh_mass_properties(verts, faces, density=1.0):
    """Volume, center of mass, and inertia tensor (about the COM, in the
    mesh frame) of a watertight outward-oriented triangle mesh.

    Divergence-theorem tetrahedron decomposition against the origin (the
    integrals of `TessellatedPolyhedron::calc_volume_ints`, reference
    src/TessellatedPolyhedron.cpp). Returns
    (volume, com (3,), J (3,3) about com, mass) at the given density.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    # signed tetra volumes against the origin
    cr = np.cross(b, c)
    vol6 = np.einsum("ij,ij->i", a, cr)   # 6 * signed volume
    volume = vol6.sum() / 6.0
    # integral of x over the tet (0, a, b, c) = vol6/24 * (a + b + c)
    com = ((a + b + c) * vol6[:, None] / 24.0).sum(axis=0) / max(volume, 1e-300)

    # second moments: sum over tets of (vol6/120) * (PᵀP + s sᵀ), P's rows
    # a, b, c and s their sum
    C = np.zeros((3, 3))
    for i in range(len(a)):
        P = np.stack([a[i], b[i], c[i]])
        s = P.sum(axis=0)
        C += (P.T @ P + np.outer(s, s)) * (vol6[i] / 120.0)
    # shift to COM
    C -= volume * np.outer(com, com)
    J = np.eye(3) * np.trace(C) - C
    mass = density * volume
    return volume, com, density * J, mass


def mesh_inertia(mass, verts, faces):
    """(3, 3) inertia about the COM scaled to the given total mass, the COM
    and the volume."""
    volume, com, J_unit, _ = mesh_mass_properties(verts, faces, density=1.0)
    if volume <= 0:
        raise ValueError("mesh has non-positive volume (check orientation)")
    return J_unit * (mass / volume), com, volume


# ------------------------------------------------- point-triangle functions

def _safe_div(x, y):
    return x / torch.where(y.abs() > 1e-30, y, torch.ones_like(y))


def _mul_sub(x1, y1, x2, y2):
    """x1·y1 − x2·y2 as fma(x1, y1, −x2·y2)."""
    return torch.addcmul(-(x2 * y2), x1, y1)


def _closest_points(p, a, b, c):
    """The closest point on triangle (a, b, c) to p twice: as the JAX
    package's jitted CPU code stores it, and as it rounds it inside its fused
    distance |p - q|. The two differ only on the edge ac, whose point
    a + ac·w is a multiply and an add in the first and one fused
    multiply-add in the second; the rest is shared."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3(ab, ap)
    d2 = dot3(ac, ap)
    bp = p - b
    d3 = dot3(ab, bp)
    d4 = dot3(ac, bp)
    cp = p - c
    d5 = dot3(ab, cp)
    d6 = dot3(ac, cp)

    vc = _mul_sub(d1, d4, d3, d2)
    vb = _mul_sub(d5, d2, d1, d6)
    va = _mul_sub(d3, d6, d5, d4)

    # interior
    denom = va + vb + vc
    v_int = _safe_div(vb, denom)
    w_int = _safe_div(vc, denom)
    q = torch.addcmul(torch.addcmul(a, ab, v_int[..., None]), ac, w_int[..., None])
    # edge bc
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    r_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    q = torch.where(r_bc[..., None], torch.addcmul(b, c - b, w_bc[..., None]), q)
    # edge ac
    w_ac = _safe_div(d2, d2 - d6)[..., None]
    r_ac = ((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None]
    # edge ab
    v_ab = _safe_div(d1, d1 - d3)
    r_ab = ((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None]
    e_ab = torch.addcmul(a, ab, v_ab[..., None])
    # vertices
    r_c = ((d6 >= 0) & (d5 <= d6))[..., None]
    r_b = ((d3 >= 0) & (d4 <= d3))[..., None]
    r_a = ((d1 <= 0) & (d2 <= 0))[..., None]
    q = torch.where(r_ac, a + ac * w_ac, q)
    q = torch.where(r_ab, e_ab, q)
    q = torch.where(r_c, c, q)
    q = torch.where(r_b, b, q)
    q = torch.where(r_a, a, q)
    on_ac = r_ac & ~(r_ab | r_c | r_b | r_a)
    return q, torch.where(on_ac, torch.addcmul(a, ac, w_ac), q)


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p: the branchless Voronoi-region
    select of Ericson, Real-Time Collision Detection §5.1.5. Each region's
    candidate overwrites the last in the JAX package's order, the vertex
    regions last (a wins). Broadcasts over leading dims."""
    return _closest_points(p, a, b, c)[0]


def closest_point_and_distance(p, a, b, c):
    """(q, |p − q|): `closest_point_triangle` and the distance to it, each
    rounded as the JAX package's jitted CPU code rounds it, so that faces
    that share the closest edge or vertex tie, and break their ties, as
    there."""
    q, q_fused = _closest_points(p, a, b, c)
    return q, torch.linalg.vector_norm(p - q_fused, dim=-1)


def face_side(dot, dist):
    """The side of its closest face a point lies on: sign(dot), dot =
    (p − q)·n, with 0 read as +1 (outside), as in the JAX package. In float32
    a dot within NEAR_ZERO·|p − q| of 0, (p − q) within NEAR_ZERO rad of the
    face's plane, is read as 0 as well: rounding decides its sign there, and
    a far point beside a mesh, in the plane of the face nearest to it (the
    platform's corners beside a cube resting on it), then read as inside
    gives a contact as deep as it is far. Float64 keeps the JAX package's
    exact 0 (ROADMAP §3)."""
    s = torch.sign(dot)
    on_plane = s == 0
    if dot.dtype != torch.float64:
        on_plane = on_plane | (dot.abs() <= cfg.near_zero(dot.dtype) * dist)
    return torch.where(on_plane, 1.0, s)


def sep_tol(dtype):
    """Below this separation |p − q| a mesh contact takes the face normal
    instead of the separation direction: the JAX package's 1e-9 m in float64;
    in float32 1e-9 m times NEAR_ZERO(float32)/NEAR_ZERO(float64), 2.3e-5 m,
    above which the direction of p − q is more than rounding (ROADMAP §3)."""
    if dtype == torch.float64:
        return 1e-9
    return 1e-9 * cfg.near_zero(dtype) / cfg.NEAR_ZERO_F64


def gather_triangles(verts_w, faces):
    """World triangle vertices: verts_w (..., P, V, 3) and the face-index
    table faces (P, F, 3) -> (..., P, F, 3, 3)."""
    P, F = faces.shape[:2]
    idx = faces.reshape(P, F * 3, 1).expand(verts_w.shape[:-2] + (F * 3, 3))
    return torch.gather(verts_w, -2, idx).reshape(verts_w.shape[:-2] + (F, 3, 3))


# face-axis tile size: up to this many faces the (N, F) product is formed
# whole; above it a fixed loop over face tiles bounds the working set to
# (N, FACE_CHUNK) with the identical closest-face result (the stand-in for
# the reference's BVH descent, TriangleMeshPrimitive::get_BVH_root)
FACE_CHUNK = 256


def _closest_face_block(points, tv, valid_f):
    """Min over one block of faces: (dmin (..., N), qmin, nmin), unsigned.
    points (..., N, 3), tv (..., F, 3, 3), valid_f broadcasting to (..., F)."""
    a = tv[..., None, :, 0, :]                    # (..., 1, F, 3)
    b = tv[..., None, :, 1, :]
    c = tv[..., None, :, 2, :]
    p = points[..., :, None, :]                   # (..., N, 1, 3)
    q, d = closest_point_and_distance(p, a, b, c)   # (..., N, F, 3), (..., N, F)

    nrm = torch.linalg.cross(tv[..., 1, :] - tv[..., 0, :],
                             tv[..., 2, :] - tv[..., 0, :])   # (..., F, 3)
    nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    degenerate = nlen[..., 0] < 1e-20
    nrm = nrm / nlen.clamp_min(1e-30)

    valid = valid_f & ~degenerate                 # (..., F)
    dv = torch.where(valid[..., None, :], d, torch.inf)
    imin = torch.argmin(dv, dim=-1)               # first minimum, as jnp.argmin
    qmin = torch.gather(q, -2, imin[..., None, None].expand(imin.shape + (1, 3)))[..., 0, :]
    nmin = torch.gather(nrm[..., None, :, :].expand(dv.shape + (3,)), -2,
                        imin[..., None, None].expand(imin.shape + (1, 3)))[..., 0, :]
    dmin = torch.gather(dv, -1, imin[..., None])[..., 0]
    return dmin, qmin, nmin


def points_vs_mesh(points, tv, face_valid):
    """Signed distance of query points to a watertight outward-oriented mesh.

    points (..., N, 3); tv (..., F, 3, 3) triangle vertices; face_valid
    broadcasting to (..., F). Returns (sdist (..., N), q (..., N, 3) the
    closest surface point, n_out (..., N, 3) the outward normal of its face).

    Positive outside, negative inside, by the closest face's outward normal
    (the shallow-penetration convention of the reference's
    `TriangleMeshPrimitive::calc_signed_dist`; `face_side`). Above FACE_CHUNK faces a
    fixed loop over face tiles keeps the working set at (N, FACE_CHUNK);
    the strict ``<`` merge lets an earlier tile win a tie, as the JAX
    package's scan does. No host synchronisation."""
    F = tv.shape[-3]
    if F <= FACE_CHUNK:
        dmin, qmin, nmin = _closest_face_block(points, tv, face_valid)
    else:
        fv = face_valid.expand(tv.shape[:-2])
        dmin = qmin = nmin = None
        for f0 in range(0, F, FACE_CHUNK):
            d2, q2, n2 = _closest_face_block(
                points, tv[..., f0:f0 + FACE_CHUNK, :, :], fv[..., f0:f0 + FACE_CHUNK])
            if dmin is None:
                dmin = torch.full_like(d2, torch.inf)
                qmin, nmin = torch.zeros_like(q2), torch.zeros_like(n2)
            better = d2 < dmin
            dmin = torch.where(better, d2, dmin)
            qmin = torch.where(better[..., None], q2, qmin)
            nmin = torch.where(better[..., None], n2, nmin)

    s = face_side(dot3(points - qmin, nmin), dmin)
    sdist = torch.where(torch.isfinite(dmin), s * dmin, torch.inf)
    return sdist, qmin, nmin


def extrude_polygon(poly_xz, y0, y1, apex: int = 0):
    """Watertight triangle mesh of a prism: the simple polygon `poly_xz`
    ((N, 2), in the xz plane, any winding) extruded along y from y0 to y1.

    Caps are fan-triangulated from vertex `apex`, so the polygon must be
    star-shaped as seen from that vertex (true for convex polygons from any
    vertex, and for a V-notch channel from the notch vertex). Faces come out
    outward-oriented; a polygon that gives a non-positive volume raises
    ValueError. Returns (verts (2N, 3), faces (4N − 4, 3) int32)."""
    poly = np.asarray(poly_xz, np.float64)
    # winding to CCW in the (x, z) plane (shoelace > 0)
    shoelace = np.sum(
        poly[:, 0] * np.roll(poly[:, 1], -1)
        - np.roll(poly[:, 0], -1) * poly[:, 1]
    )
    if shoelace < 0:
        poly = poly[::-1].copy()
        apex = len(poly) - 1 - apex
    n = len(poly)
    lo = np.stack([poly[:, 0], np.full(n, float(y0)), poly[:, 1]], axis=1)
    hi = np.stack([poly[:, 0], np.full(n, float(y1)), poly[:, 1]], axis=1)
    verts = np.concatenate([lo, hi])   # lo: 0..n-1, hi: n..2n-1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        # side quad (lo_i, hi_i, hi_j, lo_j), outward for a CCW (x, z) polygon
        faces.append([i, n + i, n + j])
        faces.append([i, n + j, j])
    for k in range(1, n - 1):
        a = apex
        b = (apex + k) % n
        c = (apex + k + 1) % n
        # CCW in (x, z) has triangle normal -y: that is the bottom cap
        faces.append([a, b, c])              # bottom cap (outward -y)
        faces.append([n + a, n + c, n + b])  # top cap (outward +y)
    faces = np.asarray(faces, np.int32)
    vol, _, _, _ = mesh_mass_properties(verts, faces)
    if vol <= 0:
        raise ValueError("extrude_polygon produced a non-positive volume "
                         "(polygon not simple, or not star-shaped from apex)")
    return verts, faces
