"""Pose-slot kinematics: world poses, velocities and generalized-coordinate
Jacobians of every rigid body and articulated link (counterpart of
``moby_tpu/sim/kinematics.py``).

The generalized-velocity vector v_gc (scene.ngc) is laid out as the
reference's eSpatial coordinates: [v; ω] per free body (6 each), then each
articulated body's joint velocities. `PoseTable.W` maps v_gc to each pose
slot's world spatial velocity ([v at slot origin; ω]): the bridge that lets
one contact-Jacobian assembly serve free bodies and articulated links alike.
For a scene of free bodies W is a constant shared by the batch
(ns, 6, ngc); with articulated bodies it depends on q and is (B, ns, 6, ngc).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import scene as sc
from ..dynamics import model as amdl
from ..math import quaternion as quat


class PoseTable(NamedTuple):
    pos: torch.Tensor    # (B, ns, 3) slot origin, world
    quat: torch.Tensor   # (B, ns, 4)
    vel: torch.Tensor    # (B, ns, 3) linear velocity of slot origin, world
    omega: torch.Tensor  # (B, ns, 3)
    W: torch.Tensor      # (ns, 6, ngc) or (B, ns, 6, ngc): v_gc -> [v; ω]


def wrench_rows(W, s, w):
    """Generalized rows w · W[s] (B, K, ngc) of the per-slot wrenches
    w (B, K, 6) applied at pose slots s (K,), for a shared or batched W."""
    if W.dim() == 3:
        return torch.einsum("bki,kij->bkj", w, W[s])
    return torch.einsum("bki,bkij->bkj", w, W[:, s])


def _free_body_W(scene: sc.Scene, dtype, device):
    """Constant (nb, 6, ngc) jacobian rows of the free bodies: identity
    blocks masked by enabled (disabled bodies have no gc in the reference;
    zero rows keep them immovable). Depends only on static scene structure,
    so it is shared by the batch."""
    def make():
        nb, ngc = scene.nb, scene.ngc
        W0 = np.zeros((nb, 6, ngc))
        enabled = scene.host["slot_enabled"][:nb]
        for b in range(nb):
            if enabled[b]:
                W0[b, :, 6 * b: 6 * b + 6] = np.eye(6)
        return torch.as_tensor(W0, dtype=dtype, device=device)

    return sc.cached(scene, ("free_body_W", str(dtype), str(device)), make)


def _art_slots(ent: sc.ABEntry, st: sc.State, ngc):
    """Poses, velocities and (B, nl, 6, ngc) W rows of one articulated
    body's links."""
    m: amdl.ArticulatedModel = ent.model
    q = st.q_art[:, ent.q_off: ent.q_off + m.nq]
    qd = st.qd_art[:, ent.v_off: ent.v_off + m.nv]
    B = q.shape[0]
    Xs, Ss = amdl.joint_transforms(m, q)

    Rs, ps, Wl = [], [], []  # Wl: per-link (B, 6=[v,ω], nv) world jacobian
    for i in range(m.nl):
        X = Xs[i]
        p_par = m.parent[i]
        if p_par < 0:
            R = X.E.transpose(-1, -2)
            p = X.r
            Wp = q.new_zeros((B, 6, m.nv))
        else:
            Rp, pp = Rs[p_par], ps[p_par]
            R = Rp @ X.E.transpose(-1, -2)
            p = pp + (Rp @ X.r[..., None])[..., 0]
            Wpar = Wl[p_par]
            # shift the parent jacobian from the parent origin to this link
            # origin: v_col_new = v_col + ω_col × r
            r = (p - pp)[:, None, :]
            shift = torch.linalg.cross(Wpar[:, 3:].transpose(-1, -2),
                                       r.expand(B, m.nv, 3)).transpose(-1, -2)
            Wp = torch.cat([Wpar[:, :3] + shift, Wpar[:, 3:]], dim=1)
        # this joint's own columns: S expressed in the link frame
        S = Ss[i]
        nvi = S.shape[-1]
        if nvi:
            cols = torch.cat([R @ S[:, 3:], R @ S[:, :3]], dim=1)  # [lin; ang]
            vo = m.v_off[i]
            Wp = torch.cat([Wp[..., :vo], Wp[..., vo: vo + nvi] + cols,
                            Wp[..., vo + nvi:]], dim=-1)
        Wl.append(Wp)
        Rs.append(R)
        ps.append(p)

    W = torch.stack(Wl, dim=1)                               # (B, nl, 6, nv)
    sv = (W @ qd[:, None, :, None])[..., 0]                  # (B, nl, 6)
    W = torch.nn.functional.pad(W, (ent.gc_off, ngc - ent.gc_off - m.nv))
    return (torch.stack(ps, dim=1), quat.from_matrix(torch.stack(Rs, dim=1)),
            sv[..., :3], sv[..., 3:], W)


def compute(scene: sc.Scene, st: sc.State) -> PoseTable:
    dtype, device = st.pos.dtype, st.pos.device
    if not scene.arts:
        # free bodies only: the state IS the pose table; W is a constant
        return PoseTable(
            pos=st.pos, quat=st.quat, vel=st.vel, omega=st.omega,
            W=_free_body_W(scene, dtype, device),
        )
    # slot tables assemble by concatenation: free bodies, then each
    # articulated body's links in slot order
    B = st.pos.shape[0]
    parts = []
    if scene.nb:
        Wf = _free_body_W(scene, dtype, device)
        parts.append((st.pos, st.quat, st.vel, st.omega,
                      Wf[None].expand((B,) + Wf.shape)))
    for ent in scene.arts:
        parts.append(_art_slots(ent, st, scene.ngc))
    pos, qt, vel, omega, W = (torch.cat(x, dim=1) for x in zip(*parts))
    return PoseTable(pos=pos, quat=qt, vel=vel, omega=omega, W=W)


def gc_velocity(scene: sc.Scene, st: sc.State):
    """Assemble the generalized velocity vectors, (B, ngc)."""
    B = st.pos.shape[0]
    parts = []
    if scene.nb:
        parts.append(torch.cat([st.vel, st.omega], dim=-1).reshape(B, -1))
    if scene.nv_art:
        parts.append(st.qd_art)
    if not parts:
        return st.pos.new_zeros((B, 0))
    return torch.cat(parts, dim=-1)


def apply_gc_velocity_delta(scene: sc.Scene, st: sc.State, dv):
    """Scatter a gc-velocity delta (B, ngc) back into the state."""
    nb = scene.nb
    if nb:
        dvb = dv[:, : 6 * nb].reshape(-1, nb, 6)
        st = st.replace(vel=st.vel + dvb[..., :3], omega=st.omega + dvb[..., 3:])
    if scene.nv_art:
        st = st.replace(qd_art=st.qd_art + dv[:, 6 * nb:])
    return st
