"""Vectorized narrow-phase collision kernels (counterpart of
``moby_tpu/geometry/narrowphase.py``): sphere-sphere, sphere-plane,
box-sphere, plane-vertex solid (boxes, polyhedra and triangle meshes),
box-box, the closed-form cylinder-, cone- and torus-plane kinds,
convex-convex (GJK with the exact or sampled MTV), and the triangle-mesh
kinds: sphere-mesh, mesh-box and mesh-mesh (also mesh-polyhedron, through
the polyhedron's hull triangles).

Each *kind* of pair is processed as one vectorized function over all pairs of
that kind (static host-side grouping) and the whole batch, producing

* pairwise signed distances + closest points (for conservative advancement;
  reference `CCD::calc_signed_dist`), and
* contact slots (point, normal, depth, active) mirroring each
  `CCD::find_contacts_*` specialization's conventions: which geometry is
  `contact_geom1`, where the contact point sits, which way the normal points.

All outputs are fixed-shape (B, K contact slots) with boolean activity masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import config as cfg
from ..core import scene as sc
from ..math import quaternion as quat
from ..math.linalg import dot3
from ..math.so3 import orthonormal_basis
from . import trimesh as tmesh


class PairDist(NamedTuple):
    dist: torch.Tensor  # (B, NP)
    pa: torch.Tensor    # (B, NP, 3) closest point on geometry A (world)
    pb: torch.Tensor    # (B, NP, 3) closest point on geometry B (world)


class Contacts(NamedTuple):
    active: torch.Tensor  # (B, K) bool
    point: torch.Tensor   # (B, K, 3)
    normal: torch.Tensor  # (B, K, 3) from geom2's body toward geom1's body
    depth: torch.Tensor   # (B, K) signed distance at creation
    tan1: torch.Tensor    # (B, K, 3)
    tan2: torch.Tensor    # (B, K, 3)
    # per-slot identity: the compile-time scene.slot_s1/slot_s2/slot_pair
    # tables (shared by the batch; pooled slots would make them data)
    s1: torch.Tensor = None    # (K,) pose slot of geom1
    s2: torch.Tensor = None    # (K,) pose slot of geom2
    pair: torch.Tensor = None  # (K,) owning candidate pair


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def geom_world_pose(scene: sc.Scene, pos, quat_b, gidx):
    """World pose of geometries gidx (static numpy indices): pose-slot pose ∘
    local pose. `pos`/`quat_b` are pose-table arrays (B, n_pose_slots, ·)."""
    b = scene.host["geom_slot"][gidx]
    bp = pos[:, b]
    bq = quat_b[:, b]
    gp = bp + quat.rotate(bq, scene.geom_pos[gidx])
    gq = quat.mul(bq, scene.geom_quat[gidx].expand_as(bq))
    return gp, gq


def _pair_geoms(scene, pairs):
    return scene.host["pair_g1"][pairs], scene.host["pair_g2"][pairs]


def _sphere_sphere(scene, pos, quat_b, pairs):
    ga, gb = _pair_geoms(scene, pairs)
    ca, _ = geom_world_pose(scene, pos, quat_b, ga)
    cb, _ = geom_world_pose(scene, pos, quat_b, gb)
    ra = scene.geom_params[ga, 0]
    rb = scene.geom_params[gb, 0]
    d = ca - cb
    dn = _norm(d)
    dist = dn - ra - rb
    n = d / dn.clamp_min(1e-30)[..., None]
    pa = ca - n * ra[..., None]
    pb = cb + n * rb[..., None]
    point = 0.5 * (pa + pb)
    return dist, pa, pb, point[:, :, None, :], n[:, :, None, :], dist[:, :, None]


def _axis(q, k):
    """World direction of local axis k (0, 1, 2) of orientations q."""
    e = [0.0, 0.0, 0.0]
    e[k] = 1.0
    return quat.rotate(q, q.new_tensor(e))


def _plane_up(pq):
    return _axis(pq, 1)


def _sphere_plane(scene, pos, quat_b, pairs):
    ga, gb = _pair_geoms(scene, pairs)   # sphere, plane
    ca, _ = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    r = scene.geom_params[ga, 0]
    up = _plane_up(pq)
    y = torch.sum((ca - pp) * up, dim=-1)
    dist = y - r
    # contact point: midway between sphere bottom and the plane surface
    # (reference CCD.inl find_contacts_sphere_plane: y = (y_c - r)/2)
    point = ca - up * ((y + r) / 2)[..., None]
    pa = ca - up * r[..., None]       # lowest point of sphere
    pb = ca - up * y[..., None]       # projection on plane
    n = up
    return dist, pa, pb, point[:, :, None, :], n[:, :, None, :], dist[:, :, None]


def _box_sphere(scene, pos, quat_b, pairs):
    ga, gb = _pair_geoms(scene, pairs)   # box, sphere
    bp, bq = geom_world_pose(scene, pos, quat_b, ga)
    cs, _ = geom_world_pose(scene, pos, quat_b, gb)
    half = scene.geom_params[ga, :3]
    r = scene.geom_params[gb, 0]
    # sphere center in box frame
    cl = quat.inverse_rotate(bq, cs - bp)
    clamped = torch.maximum(torch.minimum(cl, half), -half)
    dvec = cl - clamped
    dn = _norm(dvec)
    outside = dn > 1e-12
    # center inside the box: distance to the nearest face (negative)
    face_d = half - cl.abs()  # >= 0 when inside
    min_face = face_d.amin(dim=-1)
    dist = torch.where(outside, dn - r, -(min_face) - r)
    # closest point on box (world)
    pbox = bp + quat.rotate(bq, clamped)
    dirn = dvec / dn.clamp_min(1e-30)[..., None]
    dir_world = quat.rotate(bq, dirn)
    psph = cs - dir_world * r[..., None]
    sep = dist > 0
    point = torch.where(sep[..., None], 0.5 * (psph + pbox), psph)
    # normal: from sphere(B) toward box(A) (reference find_contacts_box_sphere)
    n_sep = pbox - psph
    n_sep = n_sep / _norm(n_sep, keepdim=True).clamp_min(1e-30)
    # overlapping: use direction from box center to sphere center (fallback)
    n_pen = -dir_world
    n = torch.where(sep[..., None], n_sep, n_pen)
    return dist, pbox, psph, point[:, :, None, :], n[:, :, None, :], dist[:, :, None]


def _total_order(x):
    """Integer keys that sort floats in IEEE total order: -NaN < -inf < ... <
    -0.0 < 0.0 < ... < inf < NaN, a NaN by its sign bit."""
    bits = x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    mag = torch.iinfo(bits.dtype).max
    return bits ^ ((bits >> (8 * bits.element_size() - 1)) & mag)


def _topk_slots(sdist, k):
    """Indices + values of the k smallest signed distances (per row), the
    lower index first among equal ones: what the JAX package's
    ``lax.top_k(-sdist, k)`` gives. That orders by IEEE total order (a -0.0
    before a 0.0, a NaN with its sign bit set before everything, one without
    it after inf), so the port sorts stably by the same key. (`torch.topk`
    leaves ties in no fixed order.)"""
    idx = torch.sort(_total_order(sdist), dim=-1, stable=True)[1][..., :k]
    return idx, torch.gather(sdist, -1, idx)


def _take(x, idx):
    """take_along_axis over the vertex axis (-2 for points, -1 for scalars)."""
    if x.dim() == idx.dim() + 1:
        return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))
    return torch.gather(x, -1, idx)


def _plane_generic(scene, pos, quat_b, pairs, nslots):
    """A = plane, B = solid with vertices; one slot per vertex of B
    (reference CCD.inl find_contacts_plane_generic: contacts at B's vertices
    with normal = -plane_up, geom1 = plane). Solids with more vertices than
    slots contribute their `nslots` deepest vertices."""
    ga, gb = _pair_geoms(scene, pairs)   # plane, vertex solid
    pp, pq = geom_world_pose(scene, pos, quat_b, ga)
    sp, sq = geom_world_pose(scene, pos, quat_b, gb)
    up = _plane_up(pq)
    verts = scene.geom_verts[gb]                      # (P, V, 3) local
    V = verts.shape[1]
    nv = scene.geom_nverts[gb]                        # (P,)
    vw = sp[:, :, None, :] + quat.rotate(sq[:, :, None, :], verts)  # world
    y = torch.sum((vw - pp[:, :, None, :]) * up[:, :, None, :], dim=-1)  # (B,P,V)
    valid = (torch.arange(V, device=pos.device)[None, :] < nv[:, None]).expand_as(y)
    inf = torch.full_like(y, torch.inf)
    yv = torch.where(valid, y, inf)
    dist = yv.amin(dim=-1)
    # closest points: the lowest vertex and its projection on the plane
    imin = torch.argmin(yv, dim=-1)
    vmin = _take(vw, imin[..., None])[..., 0, :]
    pbv = vmin
    pav = vmin - up * _take(y, imin[..., None])
    if nslots < V:
        idx, _ = _topk_slots(yv, nslots)              # deepest nslots
        vw = _take(vw, idx)
        y = _take(y, idx)
        valid = _take(valid, idx)
    # per-vertex contact slots: normal = -up (geom1 = plane)
    n = (-up[:, :, None, :]).expand_as(vw)
    sdist = torch.where(valid, y, torch.full_like(y, torch.inf))
    return dist, pav, pbv, vw, n, sdist


def _rim(center, radius, angles, e1, e2):
    """Points center + radius·(cos θ e1 + sin θ e2) for each angle:
    (B, P, 3) centres and frames, (P,) radii, (4,) angles -> (B, P, 4, 3)."""
    r = radius[:, None, None]
    return (center[:, :, None, :]
            + r * torch.cos(angles)[None, :, None] * e1[:, :, None, :]
            + r * torch.sin(angles)[None, :, None] * e2[:, :, None, :])


def _unit(v):
    return v / _norm(v, keepdim=True).clamp_min(1e-30)


def _align_tol(dtype):
    """How far from parallel or perpendicular a curved solid's axis may be
    for its flat cases (a cylinder's cap or side, a cone's base): the JAX
    package's 1e-8 in float64. In float32 1 - 1e-8 rounds to 1, so those
    cases could never hold there; the port takes 1e-6 (ROADMAP §3)."""
    return 1e-8 if dtype == torch.float64 else 1e-6


def _cylinder_plane(scene, pos, quat_b, pairs):
    """A = cylinder (axis = local Y), B = plane; up to 4 contacts
    (reference CCD.inl find_contacts_cylinder_plane)."""
    ga, gb = _pair_geoms(scene, pairs)
    cp_, cq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    R = scene.geom_params[ga, 0]
    H = scene.geom_params[ga, 1]
    up = _plane_up(pq)
    axis = _axis(cq, 1)
    n_dot = torch.sum(up * axis, dim=-1)
    axial = torch.where(n_dot[..., None] > 0, -axis, axis)  # toward the plane

    tol = _align_tol(pos.dtype)
    perp = n_dot.abs() > 1.0 - tol    # axis ⟂ plane (an end cap rests)
    par = n_dot.abs() < tol           # axis ∥ plane (the side rests)

    # end-cap case: 4 rim points around the low cap
    x_cap = cp_ + axial * (H / 2)[..., None]
    t1, t2 = orthonormal_basis(up)
    angles = torch.arange(4, dtype=pos.dtype, device=pos.device) * (math.pi / 2)
    rim = _rim(x_cap, R, angles, t1, t2)
    d_cap = torch.sum((x_cap - pp) * up, dim=-1)

    # side case: the 2 end points of the lowest line
    x_side = cp_ - up * R[..., None]
    e1 = x_side + axial * (H / 2)[..., None]
    e2 = x_side - axial * (H / 2)[..., None]
    d_side = torch.sum((x_side - pp) * up, dim=-1)

    # edge case: the single lowest rim point
    radial = _unit(torch.linalg.cross(axial, torch.linalg.cross(axial, up)))
    x_edge = cp_ + axial * (H / 2)[..., None] + radial * R[..., None]
    d_edge = torch.sum((x_edge - pp) * up, dim=-1)

    dist = torch.where(perp, d_cap, torch.where(par, d_side, d_edge))
    pts = torch.where(
        perp[..., None, None], rim,
        torch.where(par[..., None, None], torch.stack([e1, e2, e1, e2], dim=2),
                    torch.stack([x_edge] * 4, dim=2)))
    nact = torch.where(perp, 4, torch.where(par, 2, 1))
    valid = torch.arange(4, device=pos.device) < nact[..., None]
    sdist = torch.where(valid, dist[..., None], torch.inf)
    n = up[:, :, None, :].expand_as(pts)
    pa = torch.where(perp[..., None], x_cap, torch.where(par[..., None], x_side, x_edge))
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _cone_plane(scene, pos, quat_b, pairs):
    """A = cone (axis = local Y, apex at +H/2, base radius R at -H/2:
    ConePrimitive::calc_signed_dist, src/ConePrimitive.cpp:110-150),
    B = plane. Cases: base resting -> 4 rim points; slant resting (axis/plane
    angle = half-angle) -> apex + lowest rim point; otherwise the single
    lowest feature (apex or base rim)."""
    ga, gb = _pair_geoms(scene, pairs)
    cp_, cq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    R = scene.geom_params[ga, 0]
    H = scene.geom_params[ga, 1]
    up = _plane_up(pq)
    axis = _axis(cq, 1)
    n_dot = torch.sum(up * axis, dim=-1)

    apex = cp_ + axis * (H / 2)[..., None]
    base = cp_ - axis * (H / 2)[..., None]

    # lowest point of the base rim: walk R down-plane from the base center
    radial = torch.linalg.cross(axis, torch.linalg.cross(axis, up))
    rn = _norm(radial, keepdim=True)
    t1, _ = orthonormal_basis(axis)
    radial = torch.where(rn > 1e-12, radial / rn.clamp_min(1e-30), t1)
    rim_low = base + radial * R[..., None]

    d_apex = torch.sum((apex - pp) * up, dim=-1)
    d_rim = torch.sum((rim_low - pp) * up, dim=-1)

    # base-flat case: axis anti-parallel to up (the base faces the plane)
    flat = n_dot > 1.0 - _align_tol(pos.dtype)
    # slant case: apex and lowest rim point equally close
    half_angle = torch.atan2(R, H)
    tilt = torch.arccos(n_dot.abs().clamp(0.0, 1.0))
    slant = ((math.pi / 2 - tilt) - half_angle).abs() < 1e-6

    # base rim points (4) for the flat case
    bt1, bt2 = orthonormal_basis(up)
    angles = torch.arange(4, dtype=pos.dtype, device=pos.device) * (math.pi / 2)
    rim4 = _rim(base, R, angles, bt1, bt2)
    d_base = torch.sum((base - pp) * up, dim=-1)

    apex_lower = d_apex < d_rim
    d_point = torch.minimum(d_apex, d_rim)
    x_point = torch.where(apex_lower[..., None], apex, rim_low)

    dist = torch.where(flat, d_base, d_point)
    pts = torch.where(
        flat[..., None, None], rim4,
        torch.where(slant[..., None, None],
                    torch.stack([apex, rim_low, apex, rim_low], dim=2),
                    torch.stack([x_point] * 4, dim=2)))
    nact = torch.where(flat, 4, torch.where(slant, 2, 1))
    valid = torch.arange(4, device=pos.device) < nact[..., None]
    sdist = torch.where(valid, dist[..., None], torch.inf)
    n = up[:, :, None, :].expand_as(pts)
    pa = torch.where(flat[..., None], base, x_point)
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _torus_plane(scene, pos, quat_b, pairs):
    """A = torus (axis = local Z), B = plane; aligned case -> 4 ring points
    (reference CCD.inl find_contacts_torus_plane), tilted -> lowest point."""
    ga, gb = _pair_geoms(scene, pairs)
    tp, tq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    Rmaj = scene.geom_params[ga, 0]
    rmin = scene.geom_params[ga, 1]
    up = _plane_up(pq)
    k = _axis(tq, 2)
    n_dot_k = torch.sum(up * k, dim=-1)
    aligned = n_dot_k.abs() > 1.0 - 100 * 1.5e-8

    h = torch.sum((tp - pp) * up, dim=-1)
    d_aligned = h - rmin

    # aligned: 4 points on the bottom circle of radius Rmaj
    angles = (torch.arange(4, dtype=pos.dtype, device=pos.device) / 4
              * (2 * math.pi) - math.pi)
    ring = (_rim(tp, Rmaj, angles, _axis(tq, 0), _axis(tq, 1))
            - (rmin * torch.sign(n_dot_k))[..., None, None] * k[:, :, None, :])

    # tilted: the lowest point of the tube's center circle, minus rmin along
    # up; the radial direction in the torus plane pointing most downward
    rdir = _unit(torch.linalg.cross(k, torch.linalg.cross(k, up)))
    plow = tp + Rmaj[..., None] * rdir - rmin[..., None] * up
    d_tilt = torch.sum((plow - pp) * up, dim=-1)

    dist = torch.where(aligned, d_aligned, d_tilt)
    pts = torch.where(aligned[..., None, None], ring, torch.stack([plow] * 4, dim=2))
    nact = torch.where(aligned, 4, 1)
    valid = torch.arange(4, device=pos.device) < nact[..., None]
    sdist = torch.where(valid, dist[..., None], torch.inf)
    n = up[:, :, None, :].expand_as(pts)
    pa = torch.where(aligned[..., None], tp - up * (h - d_aligned)[..., None], plow)
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _point_box_dist_normal(half, p):
    """Signed distance + outward normal (box local frame) for points p
    (..., 3) against a box with half-extents `half` (Primitive
    calc_dist_and_normal semantics)."""
    clamped = torch.maximum(torch.minimum(p, half), -half)
    dvec = p - clamped
    dn = _norm(dvec)
    outside = dn > 1e-12
    face_d = half - p.abs()
    iface = torch.argmin(face_d, dim=-1)      # first minimum on ties
    min_face = _take(face_d, iface[..., None])[..., 0]
    onehot = torch.arange(3, device=p.device) == iface[..., None]
    n_in = torch.sign(p) * onehot.to(p.dtype)
    n_out = dvec / dn.clamp_min(1e-30)[..., None]
    dist = torch.where(outside, dn, -min_face)
    n = torch.where(outside[..., None], n_out, n_in)
    return dist, n


def _box_box(scene, pos, quat_b, pairs, nslots):
    """Box-box via vertex-vs-box both directions (the reference's generic
    narrow phase, CCD.inl find_contacts_generic: vA tested in B with normal
    -n_B, vB tested in A with normal +n_A; geom1 = A)."""
    ga, gb = _pair_geoms(scene, pairs)
    pa_, qa = geom_world_pose(scene, pos, quat_b, ga)
    pb_, qb = geom_world_pose(scene, pos, quat_b, gb)
    ha = scene.geom_params[ga, :3]
    hb = scene.geom_params[gb, :3]
    half_slots = nslots // 2
    V = scene.geom_verts.shape[1]

    def side(g, p_own, q_own, p_other, q_other, half_other):
        """Vertices of g (world), their signed distance to the other box and
        the other box's outward normal there (world)."""
        v_w = p_own[:, :, None, :] + quat.rotate(
            q_own[:, :, None, :], scene.geom_verts[g])
        v_l = quat.inverse_rotate(
            q_other[:, :, None, :], v_w - p_other[:, :, None, :])
        d, n_local = _point_box_dist_normal(half_other[:, None, :], v_l)
        n_w = quat.rotate(q_other[:, :, None, :], n_local)
        valid = (torch.arange(V, device=pos.device)[None, :]
                 < scene.geom_nverts[g][:, None]).expand_as(d)
        if half_slots < V:
            # slot cap: keep the deepest half_slots vertices per side
            idx, _ = _topk_slots(torch.where(valid, d, torch.inf), half_slots)
            v_w, d, n_w, valid = (_take(x, idx) for x in (v_w, d, n_w, valid))
        return v_w, torch.where(valid, d, torch.inf), n_w

    va_w, sdA, nA_w = side(ga, pa_, qa, pb_, qb, hb)   # normal: outward from B
    vb_w, sdB, nB_w = side(gb, pb_, qb, pa_, qa, ha)   # normal: outward from A

    # contact normal convention: from geom2's body toward geom1's body. An
    # A-vertex in B takes B's outward normal (toward A); a B-vertex in A takes
    # minus A's outward normal (find_contacts_generic :662), also toward A.
    pts = torch.cat([va_w, vb_w], dim=2)
    nrm = torch.cat([nA_w, -nB_w], dim=2)
    sd = torch.cat([sdA, sdB], dim=2)
    imin = torch.argmin(sd, dim=2)
    dist = _take(sd, imin[..., None])[..., 0]
    # closest points for CA: the vertex of least distance and its projection
    pmin = _take(pts, imin[..., None])[..., 0, :]
    nmin = _take(nrm, imin[..., None])[..., 0, :]
    return dist, pmin, pmin - nmin * dist[..., None], pts, nrm, sd


def _topk_by_depth(depth, valid, k):
    """Indices (..., k) of the k smallest depths among valid slots, in order
    (iterated masked first-argmin, no sort); index 0 fills in once no valid
    slot is left."""
    excl = torch.zeros_like(valid)
    chosen = []
    for _ in range(k):
        open_ = valid & ~excl
        i = torch.argmin(torch.where(open_, depth, torch.inf), dim=-1, keepdim=True)
        excl = excl.scatter(-1, i, excl.gather(-1, i) | open_.gather(-1, i))
        chosen.append(i)
    return torch.cat(chosen, dim=-1)


def _seg_seg_mid(a1, a2, b1, b2):
    """Midpoint of the closest points of segments a1-a2 and b1-b2."""
    u = a2 - a1
    v = b2 - b1
    w0 = a1 - b1
    a_ = torch.sum(u * u, -1)
    b_ = torch.sum(u * v, -1)
    c_ = torch.sum(v * v, -1)
    d_ = torch.sum(u * w0, -1)
    e_ = torch.sum(v * w0, -1)
    den = a_ * c_ - b_ * b_
    sn = torch.where(den > 1e-18,
                     (b_ * e_ - c_ * d_) / torch.where(den > 1e-18, den, 1.0), 0.0)
    sn = sn.clamp(0.0, 1.0)
    tn = torch.where(c_ > 1e-18,
                     (b_ * sn + e_) / torch.where(c_ > 1e-18, c_, 1.0), 0.0)
    tn = tn.clamp(0.0, 1.0)
    pa2 = a1 + u * sn[..., None]
    pb2 = b1 + v * tn[..., None]
    return 0.5 * (pa2 + pb2)


def _convex_convex(scene, pos, quat_b, pairs):
    """General convex pair: batched GJK witnesses for the separated case, the
    MTV normal when touching or penetrating (exact over the hull directions
    when the scene has hull tables, else sampled), and a bidirectional
    vertex-vs-supporting-plane manifold of up to 4+4 slots, deepest first
    (the reference does polyhedral V-Clip / signed distance,
    src/Polyhedron.cpp, src/GJK.cpp). Edge-edge-only penetrations fall back
    to the closest points of the two supporting edges."""
    from . import gjk as gjk_mod

    dtype, dev = pos.dtype, pos.device
    ga, gb = _pair_geoms(scene, pairs)
    pa_, qa = geom_world_pose(scene, pos, quat_b, ga)
    pb_, qb = geom_world_pose(scene, pos, quat_b, gb)
    va = pa_[:, :, None, :] + quat.rotate(qa[:, :, None, :], scene.geom_verts[ga])
    vb = pb_[:, :, None, :] + quat.rotate(qb[:, :, None, :], scene.geom_verts[gb])
    nva = scene.geom_nverts[ga]
    nvb = scene.geom_nverts[gb]
    B, P = va.shape[:2]
    # GJK and the MTV run in float64 whatever the scene's dtype: their
    # tolerances (1e-18, 1e-10 and 1e-9 in `gjk`) are float64 sizes, and in
    # float32 the JAX package's GJK reports a 0.1 mm penetration as 0.23 m
    # of separation (ROADMAP §3). A float64 scene is unchanged.
    wide = torch.float64
    res = gjk_mod.gjk(va.to(wide), nva, vb.to(wide), nvb)
    res = gjk_mod.GJKResult(res.dist.to(dtype), res.pa.to(dtype), res.pb.to(dtype),
                            res.intersecting)
    if int(np.max(scene.host["geom_nhn"], initial=0)) > 0:
        # exact polytope penetration: the Minkowski-difference support
        # minimized over both bodies' hull face normals and the pairwise
        # edge-direction crosses (src/Polyhedron.cpp:252-340)
        fa = quat.rotate(qa[:, :, None, :], scene.geom_hull_normals[ga])
        fb = quat.rotate(qb[:, :, None, :], scene.geom_hull_normals[gb])
        ea = quat.rotate(qa[:, :, None, :], scene.geom_hull_edges[ga])
        eb = quat.rotate(qb[:, :, None, :], scene.geom_hull_edges[gb])
        FN = fa.shape[2]
        ED = ea.shape[2]
        ar_f = torch.arange(FN, device=dev)
        ar_e = torch.arange(ED, device=dev)
        ok_fa = ar_f < scene.geom_nhn[ga][:, None]
        ok_fb = ar_f < scene.geom_nhn[gb][:, None]
        ok_ea = ar_e < scene.geom_nhe[ga][:, None]
        ok_eb = ar_e < scene.geom_nhe[gb][:, None]
        cr = torch.linalg.cross(ea[:, :, :, None, :], eb[:, :, None, :, :]).reshape(
            B, P, ED * ED, 3)
        crn = _norm(cr, keepdim=True)
        ok_cr = ((ok_ea[:, :, None] & ok_eb[:, None, :]).reshape(P, ED * ED)
                 & (crn[..., 0] > 1e-9))
        cr = cr / crn.clamp_min(1e-30)
        cands = torch.cat([fa, fb, cr], dim=2)
        cand_ok = torch.cat([ok_fa.expand(B, P, FN), ok_fb.expand(B, P, FN), ok_cr],
                            dim=2)
        pen_depth, pen_n = gjk_mod.mtv_exact(va.to(wide), nva, vb.to(wide), nvb,
                                             cands.to(wide), cand_ok)
    else:
        pen_depth, pen_n = gjk_mod.mtv(va.to(wide), nva, vb.to(wide), nvb)
    pen_depth, pen_n = pen_depth.to(dtype), pen_n.to(dtype)

    d = torch.where(res.intersecting, -pen_depth, res.dist)
    n_sep = res.pa - res.pb
    nn = _norm(n_sep, keepdim=True)
    n_sep = torch.where(nn > 1e-9, n_sep / nn.clamp_min(1e-30), pen_n)
    n = torch.where(res.intersecting[..., None], pen_n, n_sep)  # B -> A

    # supporting planes: B's extreme toward A (along +n), A's toward B
    vmask_a = torch.arange(va.shape[2], device=dev) < nva[:, None]
    vmask_b = torch.arange(vb.shape[2], device=dev) < nvb[:, None]
    dots_a = dot3(va, n[:, :, None, :])
    dots_b = dot3(vb, n[:, :, None, :])
    hB = torch.where(vmask_b, dots_b, -torch.inf).amax(dim=-1)   # B top
    sA = torch.where(vmask_a, dots_a, torch.inf).amin(dim=-1)    # A bottom

    face_tol = 10 * math.sqrt(cfg.eps(dtype))

    # A's vertices against B's plane, B's against A's (depth = signed
    # distance along n)
    depth_a = dots_a - hB[..., None]
    cand_a = vmask_a & (depth_a <= face_tol)
    depth_b = sA[..., None] - dots_b
    cand_b = vmask_b & (depth_b <= face_tol)

    idx_a = _topk_by_depth(depth_a, cand_a, 4)
    idx_b = _topk_by_depth(depth_b, cand_b, 4)
    dep_a = _take(depth_a, idx_a)
    dep_b = _take(depth_b, idx_b)
    pts_a = _take(va, idx_a) - 0.5 * dep_a[..., None] * n[:, :, None, :]
    pts_b = _take(vb, idx_b) + 0.5 * dep_b[..., None] * n[:, :, None, :]
    sd_a = torch.where(_take(cand_a, idx_a), dep_a, torch.inf)
    sd_b = torch.where(_take(cand_b, idx_b), dep_b, torch.inf)

    pts = torch.cat([pts_a, pts_b], dim=2)          # (B, P, 8, 3)
    sdist = torch.cat([sd_a, sd_b], dim=2)          # (B, P, 8)
    more = torch.full((B, P, 7), torch.inf, dtype=dtype, device=dev)

    # separated: the single GJK-witness contact in slot 0
    point_sep = 0.5 * (res.pa + res.pb)
    sep = ~res.intersecting & (res.dist > face_tol)
    pts = torch.where(sep[..., None, None], point_sep[:, :, None, :], pts)
    sdist = torch.where(sep[..., None], torch.cat([res.dist[..., None], more], dim=2),
                        sdist)

    # penetrating with no vertex-plane candidate (edge-edge): the closest
    # points between the supporting segments, each body's two extreme
    # vertices along the contact normal (stable sort: ties keep their order)
    da_sorted = torch.argsort(torch.where(vmask_a, dots_a, torch.inf), dim=-1,
                              stable=True)
    db_sorted = torch.argsort(torch.where(vmask_b, -dots_b, torch.inf), dim=-1,
                              stable=True)
    fb_pt = _seg_seg_mid(
        _take(va, da_sorted[..., :1])[..., 0, :], _take(va, da_sorted[..., 1:2])[..., 0, :],
        _take(vb, db_sorted[..., :1])[..., 0, :], _take(vb, db_sorted[..., 1:2])[..., 0, :])

    have = torch.isfinite(sdist).any(dim=-1)
    pts = torch.where(have[..., None, None], pts, fb_pt[:, :, None, :])
    sdist = torch.where(have[..., None], sdist, torch.cat([d[..., None], more], dim=2))
    return d, res.pa, res.pb, pts, n[:, :, None, :].expand_as(pts), sdist


def _mesh_world_tris(scene, pos, quat_b, g, min_v=1, min_f=1):
    """World vertices (B, P, V, 3), vertex mask (P, V), world triangles
    (B, P, F, 3, 3) and face mask (P, F) of the mesh geometries g (one per
    pair). The tables are cut to the group's own largest vertex and face
    counts (at least `min_v`, `min_f`): the rows cut off are padding, which
    every mesh function masks out, so the results are those over the
    scene-wide tables, at a fraction of the work where one mesh of the scene
    is much larger than the others."""
    nverts = scene.host["geom_nverts"][g]
    nfaces = scene.host["geom_nfaces"][g]
    V = min(scene.vmax, max(min_v, int(nverts.max(initial=0))))
    F = min(scene.geom_faces.shape[1], max(min_f, int(nfaces.max(initial=0))))
    sp, sq = geom_world_pose(scene, pos, quat_b, g)
    verts = scene.geom_verts[g, :V]                   # (P, V, 3) local
    vw = sp[:, :, None, :] + quat.rotate(sq[:, :, None, :], verts)
    tv = tmesh.gather_triangles(vw, scene.geom_faces[g, :F])
    dev = pos.device
    fvalid = torch.arange(F, device=dev) < scene.geom_nfaces[g][:, None]
    vvalid = torch.arange(V, device=dev) < scene.geom_nverts[g][:, None]
    return vw, vvalid, tv, fvalid


def _dedup_points(pts, sd):
    """Mask out later slots whose contact point coincides with an earlier one
    (adjacent faces sharing the closest edge or vertex give duplicates)."""
    S = pts.shape[-2]
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    d2 = dot3(diff, diff)                                    # (..., S, S)
    ar = torch.arange(S, device=pts.device)
    earlier = ar[None, :] < ar[:, None]                      # [i, j]: j < i
    dup = ((d2 < 1e-16) & earlier).any(dim=-1)
    return torch.where(dup, torch.inf, sd)


def _sphere_trimesh(scene, pos, quat_b, pairs):
    """A = sphere, B = triangle mesh; up to 4 contacts at the nearest faces
    (the reference resolves this through the generic
    `calc_signed_dist`/`calc_dist_and_normal` dispatch over the mesh BVH,
    CCD.inl:649 + TriangleMeshPrimitive::calc_signed_dist)."""
    dtype = pos.dtype
    ga, gb = _pair_geoms(scene, pairs)   # sphere, mesh
    c, _ = geom_world_pose(scene, pos, quat_b, ga)
    r = scene.geom_params[ga, 0]
    _, _, tv, fvalid = _mesh_world_tris(scene, pos, quat_b, gb, min_f=4)

    a = tv[..., 0, :]
    b = tv[..., 1, :]
    c3 = tv[..., 2, :]
    q, d = tmesh.closest_point_and_distance(c[:, :, None, :], a, b, c3)  # (B, P, F)
    nrm = torch.linalg.cross(b - a, c3 - a)
    nlen = _norm(nrm, keepdim=True)
    nrm = nrm / nlen.clamp_min(1e-30)
    valid = fvalid & (nlen[..., 0] > 1e-20)
    # candidate faces by UNSIGNED distance (signing first would pull in far
    # faces whose outward normal faces away, e.g. the underside of a cube
    # the sphere rests on); the face-normal sign means something only for
    # the locally nearest faces
    du = torch.where(valid, d, torch.inf)
    idx, d4u = _topk_slots(du, 4)
    q4 = _take(q, idx)                                            # (B, P, 4, 3)
    n_face4 = _take(nrm, idx)
    sep_dir = c[:, :, None, :] - q4
    s4 = tmesh.face_side(dot3(sep_dir, n_face4), d4u)
    # `- r` as the JAX package writes it: r (P,) broadcasts against the 4
    # slots, which is each pair's own radius for one pair a group (a trap
    # of the JAX package for more, ROADMAP §3, matched)
    sd4 = torch.where(torch.isfinite(d4u), s4 * d4u - r, torch.inf)
    sep_len = _norm(sep_dir, keepdim=True)
    sep_n = sep_dir / sep_len.clamp_min(1e-30)
    # normal: from the mesh (geom2) toward the sphere (geom1)
    n4 = torch.where(((s4 < 0) | (sep_len[..., 0] < tmesh.sep_tol(dtype)))[..., None],
                     n_face4, sep_n)
    sd4 = _dedup_points(q4, sd4)

    dist = sd4[..., 0]
    pb = q4[..., 0, :]
    pa = c - n4[..., 0, :] * r[:, None]
    pts = 0.5 * (q4 + (c[:, :, None, :] - n4 * r[:, None, None]))
    return dist, pa, pb, pts, n4, sd4


def _box_point_sdf(half, cl):
    """Signed distance, closest surface point (box frame) and outward normal
    of points cl (B, P, N, 3), in the box frame, against boxes of
    half-extents half (P, 3)."""
    h = half[:, None, :]
    clamped = torch.minimum(torch.maximum(cl, -h), h)
    dvec = cl - clamped
    dn = _norm(dvec)
    outside = dn > 1e-12
    face_d = h - cl.abs()                               # (B, P, N, 3)
    ax = torch.argmin(face_d, dim=-1)                   # first minimum
    min_face = face_d.amin(dim=-1)
    sd = torch.where(outside, dn, -min_face)
    axis_n = (torch.nn.functional.one_hot(ax, 3).to(cl.dtype)
              * torch.sign(_take(cl, ax[..., None])))
    n_out = torch.where(outside[..., None], dvec / dn.clamp_min(1e-30)[..., None], axis_n)
    # surface point: the clamp (outside) or the projection along the axis
    surf_in = torch.addcmul(cl, n_out, min_face[..., None])
    surf = torch.where(outside[..., None], clamped, surf_in)
    return sd, surf, n_out


_BOX_CORNER_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                     for sz in (-1.0, 1.0)]


def _trimesh_convex(scene, pos, quat_b, pairs, nslots):
    """A = triangle mesh, B = box. nslots - 8 slots: the mesh's deepest
    vertices against the box's signed distance; 8 slots: the box's corners
    against the mesh surface. (Reference: the generic vertex /
    `calc_dist_and_normal` dispatch, CCD.inl:649.)"""
    dtype = pos.dtype
    ga, gb = _pair_geoms(scene, pairs)   # mesh, box
    bp, bq = geom_world_pose(scene, pos, quat_b, gb)
    half = scene.geom_params[gb, :3]
    nsl_v = nslots - 8   # vertex slots (the cap); the other 8 are box corners
    vw, vvalid, tv, fvalid = _mesh_world_tris(scene, pos, quat_b, ga, min_v=nsl_v)
    bq_v = bq[:, :, None, :]

    # mesh vertices against the box
    cl = quat.inverse_rotate(bq_v, vw - bp[:, :, None, :])
    sd_v, surf, n_loc = _box_point_sdf(half, cl)
    sd_v = torch.where(vvalid, sd_v, torch.inf)
    n_v = quat.rotate(bq_v, n_loc)      # outward from the box = geom2 -> geom1
    pts_v = vw

    # box corners against the mesh surface
    corners_l = (torch.tensor(_BOX_CORNER_SIGNS, dtype=dtype, device=pos.device)
                 * half[:, None, :])                              # (P, 8, 3)
    cw = bp[:, :, None, :] + quat.rotate(bq_v, corners_l)        # (B, P, 8, 3)
    sd_c, q_c, n_out = tmesh.points_vs_mesh(cw, tv, fvalid)
    sep_dir = q_c - cw
    sep_len = _norm(sep_dir, keepdim=True)
    sep_n = sep_dir / sep_len.clamp_min(1e-30)
    # normal from the box (geom2) toward the mesh (geom1): minus the mesh's
    # outward normal where the corner has penetrated (or sits exactly on the
    # surface), toward the surface otherwise
    n_c = torch.where(((sd_c < 0) | (sep_len[..., 0] < tmesh.sep_tol(dtype)))[..., None],
                      -n_out, sep_n)
    pts_c = cw
    sd_c = torch.where(torch.isfinite(sd_c), sd_c, torch.inf)

    # closest points for the conservative-advancement direction, on the mesh
    # (pa) and on the box (pb), over every vertex before the slot cap
    surf_w = bp[:, :, None, :] + quat.rotate(bq_v, surf)
    sdist_full = torch.cat([sd_v, sd_c], dim=-1)
    pa_all = torch.cat([vw, q_c], dim=-2)
    pb_all = torch.cat([surf_w, cw], dim=-2)
    dist = sdist_full.amin(dim=-1)
    imin = torch.argmin(sdist_full, dim=-1)
    pa = _take(pa_all, imin[..., None])[..., 0, :]
    pb = _take(pb_all, imin[..., None])[..., 0, :]

    if nsl_v < scene.vmax:
        # slot cap: the deepest nsl_v mesh vertices
        idx, _ = _topk_slots(sd_v, nsl_v)
        pts_v, n_v, sd_v = _take(pts_v, idx), _take(n_v, idx), _take(sd_v, idx)

    pts = torch.cat([pts_v, pts_c], dim=-2)
    nrm = torch.cat([n_v, n_c], dim=-2)
    sdist = torch.cat([sd_v, sd_c], dim=-1)
    return dist, pa, pb, pts, nrm, sdist


def _mesh_side(scene, vw, vvalid, tv_other, fvalid_other, toward):
    """The deepest 4 vertices of one mesh against the other's surface:
    (points, closest points on the other, normal from geom2 toward geom1,
    signed distances). `toward` is +1 when these vertices are geom1's (the
    normal is the other's outward one) and -1 when they are geom2's."""
    sd, q, n_out = tmesh.points_vs_mesh(vw, tv_other, fvalid_other)
    sd = torch.where(vvalid, sd, torch.inf)
    idx, sd4 = _topk_slots(sd, 4)
    pts, q4, nout4 = _take(vw, idx), _take(q, idx), _take(n_out, idx)
    sep = (pts - q4) if toward > 0 else (q4 - pts)
    sep_len = _norm(sep, keepdim=True)
    sep_n = sep / sep_len.clamp_min(1e-30)
    # the other's outward normal (signed) where penetrating or exactly on
    # its surface (the separation vanishes), else the separation direction
    use = (sd4 < 0) | (sep_len[..., 0] < tmesh.sep_tol(vw.dtype))
    n4 = torch.where(use[..., None], nout4 if toward > 0 else -nout4, sep_n)
    return pts, q4, n4, sd4


def _trimesh_trimesh(scene, pos, quat_b, pairs):
    """A, B triangle meshes (a POLYHEDRON through its hull triangles): the
    deepest 4 vertices of each against the other's surface
    (vertex-vs-closest-triangle with the face-normal sign)."""
    ga, gb = _pair_geoms(scene, pairs)
    vwA, vvA, tvA, fvA = _mesh_world_tris(scene, pos, quat_b, ga, min_v=4)
    vwB, vvB, tvB, fvB = _mesh_world_tris(scene, pos, quat_b, gb, min_v=4)
    ptsA, qA4, nA4, sd4A = _mesh_side(scene, vwA, vvA, tvB, fvB, +1)
    ptsB, qB4, nB4, sd4B = _mesh_side(scene, vwB, vvB, tvA, fvA, -1)

    pts = torch.cat([ptsA, ptsB], dim=-2)
    nrm = torch.cat([nA4, nB4], dim=-2)
    sdist = _dedup_points(pts, torch.cat([sd4A, sd4B], dim=-1))

    # pa on mesh A, pb on mesh B (the CA direction pa - pb must not vanish)
    pa_all = torch.cat([ptsA, qB4], dim=-2)
    pb_all = torch.cat([qA4, ptsB], dim=-2)
    dist = sdist.amin(dim=-1)
    imin = torch.argmin(sdist, dim=-1)
    pa = _take(pa_all, imin[..., None])[..., 0, :]
    pb = _take(pb_all, imin[..., None])[..., 0, :]
    return dist, pa, pb, pts, nrm, sdist


_KERNELS = {
    sc.K_SPHERE_SPHERE: _sphere_sphere,
    sc.K_SPHERE_PLANE: _sphere_plane,
    sc.K_BOX_SPHERE: _box_sphere,
    sc.K_CYLINDER_PLANE: _cylinder_plane,
    sc.K_TORUS_PLANE: _torus_plane,
    sc.K_CONE_PLANE: _cone_plane,
    sc.K_CONVEX_CONVEX: _convex_convex,
    sc.K_SPHERE_TRIMESH: _sphere_trimesh,
    sc.K_TRIMESH_TRIMESH: _trimesh_trimesh,
}
# the kinds whose functions take the group's slot count (they top-k to it)
_SLOTTED = {
    sc.K_PLANE_GENERIC: _plane_generic,
    sc.K_BOX_BOX: _box_box,
    sc.K_TRIMESH_CONVEX: _trimesh_convex,
}


def _perm(scene, name, parts, device):
    """Static inverse permutation that undoes the kind grouping."""
    return sc.cached(
        scene, ("perm", name, str(device)),
        lambda: torch.as_tensor(np.argsort(np.concatenate(parts)), device=device))


def narrow_phase(scene: sc.Scene, pos, quat_b, tol):
    """Pairwise distances and contact slots at the given configuration.

    Returns (PairDist, Contacts). A contact slot is active when its own signed
    distance <= tol AND the owning pair's distance < tol (reference:
    ConstraintSimulator::find_unilateral_constraints, src:488-537, combined
    with each find_contacts_* kernel's own `dist > TOL` cull). `tol` is a
    Python float or a tensor that broadcasts against (B, K).
    """
    NP_ = scene.n_pairs
    K = scene.n_contacts
    B = pos.shape[0]
    dtype, device = pos.dtype, pos.device

    # per-kind outputs are gathered by a STATIC permutation: the kind groups
    # partition pairs/slots exactly once
    d_parts, a_parts, b_parts = [], [], []
    pt_parts, n_parts, sd_parts = [], [], []
    pair_idx_parts, slot_idx_parts = [], []

    for grp in scene.kind_groups.values():
        kind = grp["kind"]
        pairs = grp["pairs"]
        if len(pairs) == 0:
            continue
        if kind in _SLOTTED:
            d, a, b, pts, nrm, sd = _SLOTTED[kind](scene, pos, quat_b, pairs,
                                                   grp["nslots"])
        elif kind in _KERNELS:
            d, a, b, pts, nrm, sd = _KERNELS[kind](scene, pos, quat_b, pairs)
        else:
            raise NotImplementedError(
                f"narrow-phase kind {kind} is not ported yet")
        d_parts.append(d)
        a_parts.append(a)
        b_parts.append(b)
        pt_parts.append(pts.reshape(B, -1, 3))
        n_parts.append(nrm.reshape(B, -1, 3))
        sd_parts.append(sd.reshape(B, -1))
        pair_idx_parts.append(pairs)
        slot_idx_parts.append(grp["slots"])

    if pair_idx_parts:
        pair_perm = _perm(scene, "pair", pair_idx_parts, device)
        dist = torch.cat(d_parts, dim=1)[:, pair_perm]
        pa = torch.cat(a_parts, dim=1)[:, pair_perm]
        pb = torch.cat(b_parts, dim=1)[:, pair_perm]
    else:
        dist = pos.new_zeros((B, NP_))
        pa = pos.new_zeros((B, NP_, 3))
        pb = pos.new_zeros((B, NP_, 3))
    if slot_idx_parts and K:
        slot_perm = _perm(scene, "slot", slot_idx_parts, device)
        cpoint = torch.cat(pt_parts, dim=1)[:, slot_perm]
        cnormal = torch.cat(n_parts, dim=1)[:, slot_perm]
        csdist = torch.cat(sd_parts, dim=1)[:, slot_perm]
    else:
        cpoint = pos.new_zeros((B, K, 3))
        cnormal = pos.new_zeros((B, K, 3))
        csdist = torch.full((B, K), torch.inf, dtype=dtype, device=device)

    pair_dist_of_slot = dist[:, scene.slot_pair]
    active = (csdist <= tol) & (pair_dist_of_slot < tol)
    t1, t2 = orthonormal_basis(cnormal)
    return (
        PairDist(dist=dist, pa=pa, pb=pb),
        Contacts(
            active=active,
            point=cpoint,
            normal=cnormal,
            depth=torch.where(torch.isfinite(csdist), csdist, 0.0),
            tan1=t1,
            tan2=t2,
            s1=scene.slot_s1,
            s2=scene.slot_s2,
            pair=scene.slot_pair,
        ),
    )


def pair_distances(scene: sc.Scene, pos, quat_b) -> PairDist:
    """Distances + closest points only."""
    pd, _ = narrow_phase(scene, pos, quat_b, torch.inf)
    return pd


def plane_generic_sweep_bound(scene: sc.Scene, pt, near_zero):
    """Vertex-sweep CA bound for touching plane-vs-vertex-solid pairs
    (CCD::calc_next_CA_Euler_step_polyhedron_plane, src/CCD.cpp:407-461).
    Returns a (B, n_pairs) bound.

    The JAX package's function looks its plane-generic groups up by kind in a
    table that is keyed by (kind, nslots), finds none, and so returns +inf
    for every pair (the reference's "don't know what to do" fallback). The
    port returns that same value, so that trajectories agree; the sweep
    itself is recorded as a fault of the reference in ROADMAP.md."""
    B = pt.pos.shape[0]
    return torch.full((B, scene.n_pairs), torch.inf, dtype=pt.pos.dtype,
                      device=pt.pos.device)
