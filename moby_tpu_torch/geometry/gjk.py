"""Batched GJK distance between convex vertex clouds, and the penetration
depth and normal of overlapping ones (counterpart of
``moby_tpu/geometry/gjk.py``).

Every function takes leading batch dimensions (in the narrow phase: the
scenarios times the pairs of a kind) and runs a fixed number of masked
iterations, with no host synchronisation:

* `gjk`/`gjk_support`: `MAX_ITERS` iterations; a member's state freezes once
  it is done, which is what the JAX package's vmapped ``while_loop`` does.
  The closest point on the simplex comes from all 15 vertex subsets at once,
  one batched 5×5 solve (`math.linalg.solve_ex`: `torch.linalg.solve_ex`
  without error checks, LAPACK's LU on the CPU in float64) of masked
  barycentric least squares each; a singular subset (duplicate or coplanar
  points) gives non-finite barycentrics and is dropped, as
  ``jnp.linalg.solve`` makes the JAX package drop it.
* `mtv` and `mtv_support`: the sampled minimum-translation vector (42
  icosphere directions, then a fixed-count compass search).
* `mtv_exact`: the exact polytope penetration over hull face normals and
  edge-direction crosses.

Ties resolve as in the JAX package: arg-min and arg-max take the first
extremum, and "the first free slot" is the first False.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import linalg

MAX_ITERS = 32

# all nonempty subsets of {0,1,2,3}
_SUBSETS = np.array(
    [[int(bool(m & (1 << i))) for i in range(4)] for m in range(1, 16)],
    dtype=bool,
)  # (15, 4)


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _take(x, idx):
    """x[..., idx, :] for an index tensor of the leading shape."""
    return torch.gather(x, -2, idx[..., None, None].expand(
        idx.shape + (1, x.shape[-1])))[..., 0, :]


_SUBSETS_ON = {}


def _subsets(device):
    """`_SUBSETS` as a tensor on `device`, copied there once."""
    key = str(device)
    if key not in _SUBSETS_ON:
        _SUBSETS_ON[key] = torch.as_tensor(_SUBSETS, device=device)
    return _SUBSETS_ON[key]


def _closest_on_simplex(W, active):
    """Closest point to the origin on the convex hull of the active rows of
    W. W: (..., 4, 3) simplex points; active: (..., 4) bool.
    Returns (point (..., 3), barycentrics (..., 4), support mask (..., 4))."""
    dtype, dev = W.dtype, W.device
    subs = _subsets(dev)                                      # (15, 4)
    masks = subs & active[..., None, :]                       # (..., 15, 4)
    # drop subsets that are not exactly their pattern (inactive members)
    sub_valid = ~(subs & ~active[..., None, :]).any(dim=-1)   # (..., 15)
    m = masks.to(dtype)
    # minimize |sum_i b_i w_i|^2 s.t. sum b = 1, b_i = 0 off-mask: normal
    # equations with a Lagrange multiplier,
    # [G 1; 1' 0][b; λ] = [0; 1],  G_ij = w_i·w_j (masked)
    G = (W @ W.transpose(-1, -2))[..., None, :, :]            # (..., 1, 4, 4)
    pair = masks[..., :, None] & masks[..., None, :]
    A = W.new_zeros(masks.shape[:-1] + (5, 5))
    A[..., :4, :4] = (torch.where(pair, G, 0.0)
                      + torch.diag_embed(torch.where(masks, 0.0, 1.0).to(dtype)))
    A[..., :4, 4] = m
    A[..., 4, :4] = m
    rhs = W.new_zeros(masks.shape[:-1] + (5, 1))
    rhs[..., 4, 0] = 1.0
    sol = linalg.solve_ex(A, rhs)
    b = torch.where(masks, sol[..., :4, 0], 0.0)              # (..., 15, 4)
    feasible = (b >= -1e-9).all(dim=-1) & torch.isfinite(b).all(dim=-1)
    p = b @ W                                                 # (..., 15, 3)
    d2 = (p * p).sum(dim=-1)
    d2m = torch.where(feasible & sub_valid, d2, torch.inf)
    best = torch.argmin(d2m, dim=-1)                          # first minimum
    keep = subs[best] & active
    return _take(p, best), _take(b, best), keep


def support(verts, nv, d):
    """argmax_{v in verts[:nv]} v·d (vertex-cloud support point, the first
    on ties). verts (..., V, 3), nv (...,) or broadcastable, d (..., 3)."""
    dots = (verts * d[..., None, :]).sum(dim=-1)
    valid = torch.arange(verts.shape[-2], device=verts.device) < nv[..., None]
    i = torch.argmax(torch.where(valid, dots, -torch.inf), dim=-1)
    return _take(verts, i)


class GJKResult(NamedTuple):
    dist: torch.Tensor   # (...) separation distance (0 when intersecting)
    pa: torch.Tensor     # (..., 3) witness on A
    pb: torch.Tensor     # (..., 3) witness on B
    intersecting: torch.Tensor


def gjk(verts_a, nva, verts_b, nvb, max_iters: int = MAX_ITERS) -> GJKResult:
    """Distance between conv(verts_a[:nva]) and conv(verts_b[:nvb]), both in
    the same (world) frame; verts (..., V, 3), counts (...)."""

    def sup_mink(d):
        sa = support(verts_a, nva, d)
        sb = support(verts_b, nvb, -d)
        return sa - sb, sa, sb

    return gjk_support(sup_mink, verts_a.shape[:-2], verts_a.dtype,
                       verts_a.device, max_iters)


def gjk_support(sup_mink, shape, dtype, device,
                max_iters: int = MAX_ITERS) -> GJKResult:
    """GJK over a Minkowski-difference support closure
    `sup_mink(d) -> (w, sa, sb)` batched over the leading `shape` (world
    frame): the generic form the reference reaches through
    `Primitive::get_supporting_point` (src/GJK.cpp,
    include/Moby/CCD.inl:649-738)."""
    d0 = torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)
    d0[..., 0] = 1.0
    w0, a0, b0 = sup_mink(d0)
    W = torch.zeros(tuple(shape) + (4, 3), dtype=dtype, device=device)
    WA, WB = W.clone(), W.clone()
    W[..., 0, :] = w0
    WA[..., 0, :] = a0
    WB[..., 0, :] = b0
    slots = torch.arange(4, device=device)
    active = (slots == 0).expand(tuple(shape) + (4,))
    v = w0
    done = torch.zeros(tuple(shape), dtype=torch.bool, device=device)

    for _ in range(max_iters):
        wnew, anew, bnew = sup_mink(-v)
        # termination: no significant progress toward the origin
        v2 = (v * v).sum(dim=-1)
        progress = v2 - (v * wnew).sum(dim=-1)
        close_enough = progress <= 1e-10 * v2.clamp_min(1.0)

        # insert the new point into the first free slot
        free = torch.argmin(active.to(torch.int32), dim=-1)
        ins = slots == free[..., None]
        W2 = torch.where(ins[..., None], wnew[..., None, :], W)
        WA2 = torch.where(ins[..., None], anew[..., None, :], WA)
        WB2 = torch.where(ins[..., None], bnew[..., None, :], WB)
        act2 = active | ins

        p, _, keep = _closest_on_simplex(W2, act2)
        contains_origin = (p * p).sum(dim=-1) < 1e-18

        # close_enough -> the old simplex is the converged answer; otherwise
        # (origin containment included) adopt the new one. A member that is
        # done keeps its state.
        upd = ~close_enough & ~done
        W = torch.where(upd[..., None, None], W2, W)
        WA = torch.where(upd[..., None, None], WA2, WA)
        WB = torch.where(upd[..., None, None], WB2, WB)
        active = torch.where(upd[..., None], keep, active)
        v = torch.where(upd[..., None], p, v)
        done = done | close_enough | contains_origin

    p, bary, _ = _closest_on_simplex(W, active)
    pa = (bary[..., None, :] @ WA)[..., 0, :]
    pb = (bary[..., None, :] @ WB)[..., 0, :]
    dist = _norm(p)
    return GJKResult(dist=dist, pa=pa, pb=pb, intersecting=dist < 1e-9)


def _icosphere_dirs():
    """42 unit directions: icosahedron vertices + edge midpoints."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            v += [(0, s1, s2 * phi), (s1, s2 * phi, 0), (s2 * phi, 0, s1)]
    v = np.array(v, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # edge midpoints: pairs closer than the icosahedral edge length
    mids = []
    for i in range(12):
        for j in range(i + 1, 12):
            if np.linalg.norm(v[i] - v[j]) < 1.2:
                m = v[i] + v[j]
                mids.append(m / np.linalg.norm(m))
    return np.concatenate([v, np.array(mids)], axis=0)


_MTV_DIRS = _icosphere_dirs()  # (42, 3)


def _cloud_t_of(verts_a, nva, verts_b, nvb):
    """t(d) = h_A(d) + h_B(-d) of two vertex clouds, for directions
    d (..., D, 3) -> (..., D)."""
    va_ok = torch.arange(verts_a.shape[-2], device=verts_a.device) < nva[..., None]
    vb_ok = torch.arange(verts_b.shape[-2], device=verts_b.device) < nvb[..., None]

    def t_of(d):
        da = torch.einsum("...dk,...vk->...dv", d, verts_a)
        db = torch.einsum("...dk,...vk->...dv", d, verts_b)
        hA = torch.where(va_ok[..., None, :], da, -torch.inf).amax(dim=-1)
        hBm = torch.where(vb_ok[..., None, :], -db, -torch.inf).amax(dim=-1)
        return hA + hBm

    return t_of


def _compass_search(t_of, d, iters):
    """Fixed-count derivative-free descent of t on the sphere from d
    (..., 3): the best of d and four tangent steps of a shrinking size."""
    delta = torch.tensor(0.35, dtype=d.dtype, device=d.device)
    ex = d.new_tensor([1.0, 0.0, 0.0])
    ey = d.new_tensor([0.0, 1.0, 0.0])
    for _ in range(iters):
        ref = torch.where((d[..., :1].abs() < 0.9), ex, ey)
        t1 = torch.linalg.cross(d, ref)
        t1 = t1 / _norm(t1, keepdim=True).clamp_min(1e-30)
        t2 = torch.linalg.cross(d, t1)
        cands = torch.stack([
            d,
            d + delta * t1, d - delta * t1,
            d + delta * t2, d - delta * t2,
        ], dim=-2)
        cands = cands / _norm(cands, keepdim=True)
        j = torch.argmin(t_of(cands), dim=-1)
        d = _take(cands, j)
        delta = delta * 0.6
    return d


def mtv(verts_a, nva, verts_b, nvb, refine_iters: int = 8):
    """Approximate minimum-translation vector of two overlapping convex
    vertex clouds (the stand-in for EPA; the reference's penetration path is
    polyhedral V-Clip, src/Polyhedron.cpp): minimizes
    t(d) = h_A(d) + h_B(-d) over 42 fixed icosphere directions, then refines
    with `refine_iters` steps of compass search on the sphere.

    Returns (depth, n) with n the B->A contact normal (= -argmin d) and
    depth >= 0 the overlap along n. Valid only when the hulls overlap."""
    t_of = _cloud_t_of(verts_a, nva, verts_b, nvb)
    batch = verts_a.shape[:-2]
    dirs = torch.as_tensor(_MTV_DIRS, dtype=verts_a.dtype, device=verts_a.device)
    dirs = dirs.expand(batch + dirs.shape)
    d = _take(dirs, torch.argmin(t_of(dirs), dim=-1))
    d = _compass_search(t_of, d, refine_iters)
    return t_of(d[..., None, :])[..., 0], -d


def mtv_support(t_of, batch, dtype, device, refine_iters: int = 10,
                extra_dirs=None, extra_ok=None):
    """Sampled MTV over a support sum `t_of(d)` ((..., D, 3) -> (..., D),
    over the leading `batch`): the generic-pair analog of :func:`mtv` for
    primitives with closed-form support functions. `extra_dirs`
    (..., E, 3) seeds the search with problem-specific candidates, tried
    with both signs and masked by `extra_ok` (..., E). Returns (depth, n),
    n the B->A contact normal."""
    dirs = torch.as_tensor(_MTV_DIRS, dtype=dtype, device=device)
    dirs = dirs.expand(tuple(batch) + dirs.shape)
    ok = torch.ones(dirs.shape[:-1], dtype=torch.bool, device=device)
    if extra_dirs is not None:
        dirs = torch.cat([dirs, extra_dirs, -extra_dirs], dim=-2)
        ok = torch.cat([ok, extra_ok, extra_ok], dim=-1)
    t0 = torch.where(ok, t_of(dirs), torch.inf)
    d = _take(dirs, torch.argmin(t0, dim=-1))
    d = _compass_search(t_of, d, refine_iters)
    return t_of(d[..., None, :])[..., 0], -d


def mtv_exact(verts_a, nva, verts_b, nvb, cands, cand_ok):
    """Exact convex-polytope penetration depth and normal: the minimum of
    t(d) = h_A(d) + h_B(-d) over the complete candidate set `cands`
    (..., C, 3) (hull face normals of both bodies and pairwise edge-direction
    crosses), each with both signs and masked by `cand_ok` (..., C). For
    polytopes the minimizer is a face normal of the Minkowski difference, a
    member of this set, so this equals EPA's answer (the reference's
    polyhedral V-Clip / signed distance, src/Polyhedron.cpp:252-340).

    Returns (depth, n), n the B->A contact normal. Only meaningful when the
    hulls overlap."""
    t_of = _cloud_t_of(verts_a, nva, verts_b, nvb)
    D = torch.cat([cands, -cands], dim=-2)
    ok2 = torch.cat([cand_ok, cand_ok], dim=-1)
    vals = torch.where(ok2, t_of(D), torch.inf)
    i = torch.argmin(vals, dim=-1)
    return torch.gather(vals, -1, i[..., None])[..., 0], -_take(D, i)
