"""Vectorized narrow-phase collision kernels (counterpart of
``moby_tpu/geometry/narrowphase.py``; the sphere, plane and box kinds,
box-box included).

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

from typing import NamedTuple

import numpy as np
import torch

from ..core import scene as sc
from ..math import quaternion as quat
from ..math.so3 import orthonormal_basis


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


def _plane_up(pq):
    return quat.rotate(pq, pq.new_tensor([0.0, 1.0, 0.0]))


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


def _topk_slots(sdist, k):
    """Indices + values of the k smallest signed distances (per row)."""
    vals, idx = torch.topk(-sdist, k, dim=-1)
    return idx, -vals


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


_KERNELS = {
    sc.K_SPHERE_SPHERE: _sphere_sphere,
    sc.K_SPHERE_PLANE: _sphere_plane,
    sc.K_BOX_SPHERE: _box_sphere,
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
        if kind in (sc.K_PLANE_GENERIC, sc.K_BOX_BOX):
            fn = _plane_generic if kind == sc.K_PLANE_GENERIC else _box_box
            d, a, b, pts, nrm, sd = fn(scene, pos, quat_b, pairs, grp["nslots"])
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
