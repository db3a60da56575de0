"""Featherstone articulated-body algorithm (ABA), RNEA and the composite
rigid-body mass matrix (counterpart of ``moby_tpu/dynamics/aba.py``).

O(n) forward dynamics over the static link tree: the loops over links are
Python loops, and every 6-vector and 6x6 product inside them is batched
over the scenarios, q (B, nq), qd and tau (B, nv).

Conventions: [ω; v] spatial vectors in link frames; gravity enters through a
fictitious base acceleration a0 = -g (standard Featherstone trick).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..math import spatial as sp
from .model import ArticulatedModel, joint_transforms


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _gravity_accel(gravity, q):
    g = torch.as_tensor(gravity, dtype=q.dtype, device=q.device)
    return torch.cat([g.new_zeros(3), -g])


def _joint_vel(S, qd, vo):
    """S (B, 6, nv_i) @ qd[:, vo:vo+nv_i], zeros for a fixed joint."""
    nvi = S.shape[-1]
    if not nvi:
        return qd.new_zeros((qd.shape[0], 6))
    return _mv(S, qd[:, vo: vo + nvi])


def link_velocities(model: ArticulatedModel, Xs, Ss, qd):
    """Spatial velocity (B, 6) of each link in its own frame."""
    vs = []
    for i in range(model.nl):
        vJ = _joint_vel(Ss[i], qd, model.v_off[i])
        if model.parent[i] < 0:
            v = vJ
        else:
            v = sp.xform_motion(Xs[i], vs[model.parent[i]]) + vJ
        vs.append(v)
    return vs


def _cat_joints(parts, q):
    """Per-link (B, nv_i) blocks, in link order, -> (B, nv)."""
    if not parts:
        return q.new_zeros((q.shape[0], 0))
    return torch.cat(parts, dim=-1)


def aba(model: ArticulatedModel, q, qd, tau, gravity, f_ext: Optional[list] = None):
    """Forward dynamics: qdd (B, nv) from applied joint torques + external
    link forces.

    f_ext: optional list of spatial forces (B, 6) on each link, expressed in
    the link's own frame.
    """
    Xs, Ss = joint_transforms(model, q)
    nl = model.nl

    # pass 1: velocities and bias
    v = link_velocities(model, Xs, Ss, qd)
    c = [sp.cross_motion(v[i], _joint_vel(Ss[i], qd, model.v_off[i]))
         for i in range(nl)]
    IA = [model.link_inertia(i, q.dtype, q.device) for i in range(nl)]
    pA = []
    for i in range(nl):
        bias = sp.cross_force(v[i], _mv(IA[i], v[i]))
        if f_ext is not None and f_ext[i] is not None:
            bias = bias - f_ext[i]
        pA.append(bias)

    # pass 2: articulated inertia backward
    U = [None] * nl
    D_inv = [None] * nl
    u = [None] * nl
    for i in range(nl - 1, -1, -1):
        S = Ss[i]
        nvi = S.shape[-1]
        vo = model.v_off[i]
        if nvi:
            U[i] = IA[i] @ S                                  # (B, 6, nvi)
            D = S.transpose(-1, -2) @ U[i]                    # (B, nvi, nvi)
            D_inv[i] = torch.linalg.inv(D)
            u[i] = tau[:, vo: vo + nvi] - _mv(S.transpose(-1, -2), pA[i])
        p = model.parent[i]
        if p >= 0:
            if nvi:
                Ia = IA[i] - U[i] @ D_inv[i] @ U[i].transpose(-1, -2)
                pa = pA[i] + _mv(Ia, c[i]) + _mv(U[i], _mv(D_inv[i], u[i]))
            else:
                Ia = IA[i]
                pa = pA[i] + _mv(Ia, c[i])
            Xm = sp.motion_matrix(Xs[i])                       # parent -> child
            IA[p] = IA[p] + Xm.transpose(-1, -2) @ Ia @ Xm
            pA[p] = pA[p] + sp.xform_force(Xs[i].inv(), pa)

    # pass 3: accelerations forward
    a0 = _gravity_accel(gravity, q)
    a = [None] * nl
    parts = []
    for i in range(nl):
        p = model.parent[i]
        a_par = sp.xform_motion(Xs[i], a0 if p < 0 else a[p]) + c[i]
        S = Ss[i]
        if S.shape[-1]:
            qdd_i = _mv(D_inv[i], u[i] - _mv(U[i].transpose(-1, -2), a_par))
            parts.append(qdd_i)
            a[i] = a_par + _mv(S, qdd_i)
        else:
            a[i] = a_par
    return _cat_joints(parts, q)


def rnea(model: ArticulatedModel, q, qd, qdd, gravity, f_ext: Optional[list] = None):
    """Inverse dynamics: joint forces (B, nv) realizing qdd (the CRB bias
    C(q, qd) with qdd = 0, and cross-checks)."""
    Xs, Ss = joint_transforms(model, q)
    nl = model.nl
    a0 = _gravity_accel(gravity, q)

    v = [None] * nl
    a = [None] * nl
    f = [None] * nl
    for i in range(nl):
        vo = model.v_off[i]
        vJ = _joint_vel(Ss[i], qd, vo)
        aJ = _joint_vel(Ss[i], qdd, vo)
        p = model.parent[i]
        v_par = torch.zeros_like(vJ) if p < 0 else v[p]
        a_par = a0 if p < 0 else a[p]
        v[i] = sp.xform_motion(Xs[i], v_par) + vJ
        a[i] = sp.xform_motion(Xs[i], a_par) + aJ + sp.cross_motion(v[i], vJ)
        I = model.link_inertia(i, q.dtype, q.device)
        f[i] = _mv(I, a[i]) + sp.cross_force(v[i], _mv(I, v[i]))
        if f_ext is not None and f_ext[i] is not None:
            f[i] = f[i] - f_ext[i]

    parts = [None] * nl
    for i in range(nl - 1, -1, -1):
        S = Ss[i]
        if S.shape[-1]:
            parts[i] = _mv(S.transpose(-1, -2), f[i])
        p = model.parent[i]
        if p >= 0:
            f[p] = f[p] + sp.xform_force(Xs[i].inv(), f[i])
    return _cat_joints([t for t in parts if t is not None], q)


def crb(model: ArticulatedModel, q):
    """Composite-rigid-body mass matrix H(q) (B, nv, nv)."""
    Xs, Ss = joint_transforms(model, q)
    nl = model.nl
    Ic = [model.link_inertia(i, q.dtype, q.device) for i in range(nl)]
    H = q.new_zeros((q.shape[0], model.nv, model.nv))

    for i in range(nl - 1, -1, -1):
        p = model.parent[i]
        if p >= 0:
            Xm = sp.motion_matrix(Xs[i])
            Ic[p] = Ic[p] + Xm.transpose(-1, -2) @ Ic[i] @ Xm

    for i in range(nl):
        S = Ss[i]
        nvi = S.shape[-1]
        if not nvi:
            continue
        vo = model.v_off[i]
        F = Ic[i] @ S                                         # (B, 6, nvi)
        H[:, vo: vo + nvi, vo: vo + nvi] = S.transpose(-1, -2) @ F
        j = i
        while model.parent[j] >= 0:
            F = sp.motion_matrix(Xs[j]).transpose(-1, -2) @ F
            j = model.parent[j]
            Sj = Ss[j]
            nvj = Sj.shape[-1]
            if nvj:
                vj = model.v_off[j]
                blk = Sj.transpose(-1, -2) @ F               # (B, nvj, nvi)
                H[:, vj: vj + nvj, vo: vo + nvi] = blk
                H[:, vo: vo + nvi, vj: vj + nvj] = blk.transpose(-1, -2)
    return H


def fwd_dyn_crb(model: ArticulatedModel, q, qd, tau, gravity, f_ext=None):
    """Forward dynamics via H qdd = tau - C (the reference's `crb` option)."""
    H = crb(model, q)
    C = rnea(model, q, qd, torch.zeros_like(qd), gravity, f_ext)
    return torch.linalg.solve(H, tau - C)
