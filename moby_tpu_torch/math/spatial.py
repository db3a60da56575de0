"""Spatial (6-D) vector algebra (counterpart of ``moby_tpu/math/spatial.py``).

Conventions (Featherstone):
  * spatial motion vectors  v = [ω; v_lin]  (angular on top)
  * spatial force vectors   f = [τ; f_lin]
  * a coordinate transform from frame A to frame B located at r (B's origin
    expressed in A) with rotation E (maps A-vectors to B-vectors) acts on
    motion vectors as  X = [[E, 0], [-E·hat(r), E]].

A `Transform` is stored as (E, r): rotation ``E`` (..., 3, 3) mapping
parent->child coordinates and origin offset ``r`` (..., 3) of the child
frame in parent coords. Every op broadcasts over leading batch dimensions.

At the *generalized coordinate* boundary (contact Jacobians, generalized
velocities exposed to the solvers) the layout is the reference's
``[linear; angular]``; convert with :func:`to_moby_gc` / :func:`from_moby_gc`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import hat


def _mv(A, x):
    """Batched matrix-vector product A (..., m, n) @ x (..., n)."""
    return (A @ x[..., None])[..., 0]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


class Transform(NamedTuple):
    """Plücker coordinate transform child_X_parent as (E, r)."""

    E: torch.Tensor  # (..., 3, 3) rotation: parent coords -> child coords
    r: torch.Tensor  # (..., 3) child origin in parent coords

    def inv(self) -> "Transform":
        return Transform(self.E.transpose(-1, -2), -_mv(self.E, self.r))

    def compose(self, other: "Transform") -> "Transform":
        """X_self · X_other (apply `other` first, then `self`)."""
        return Transform(self.E @ other.E,
                         other.r + _mv(other.E.transpose(-1, -2), self.r))


def xform_motion(X: Transform, v):
    """Apply child_X_parent to a motion vector [ω; v]."""
    w, vl = v[..., :3], v[..., 3:]
    return torch.cat([_mv(X.E, w), _mv(X.E, vl - _cross(X.r, w))], dim=-1)


def xform_force(X: Transform, f):
    """Apply child_X_parent to a force vector [τ; f] (dual transform)."""
    t, fl = f[..., :3], f[..., 3:]
    return torch.cat([_mv(X.E, t - _cross(X.r, fl)), _mv(X.E, fl)], dim=-1)


def crm(v):
    """Spatial motion cross-product matrix (v ×)."""
    hw, hv = hat(v[..., :3]), hat(v[..., 3:])
    top = torch.cat([hw, torch.zeros_like(hw)], dim=-1)
    bot = torch.cat([hv, hw], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crf(v):
    """Spatial force cross-product matrix (v ×*) = -crm(v)^T."""
    return -crm(v).transpose(-1, -2)


def cross_motion(v, m):
    """v × m for motion vectors."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, ml) + _cross(vl, mw)], dim=-1)


def cross_force(v, f):
    """v ×* f for a force vector."""
    w, vl = v[..., :3], v[..., 3:]
    ft, fl = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, ft) + _cross(vl, fl), _cross(w, fl)], dim=-1)


def inertia_matrix(mass, com, I_com):
    """6x6 spatial inertia from mass, COM offset c (in the frame), and
    rotational inertia about the COM:
    [[I_com + m·hat(c)hat(c)', m·hat(c)], [m·hat(c)', m·1]]."""
    c = torch.as_tensor(com)
    I_com = torch.as_tensor(I_com, dtype=c.dtype)
    mass = torch.as_tensor(mass, dtype=c.dtype)
    hc = hat(c)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    mhc = mass[..., None, None] * hc
    top = torch.cat([I_com + mhc @ hc.transpose(-1, -2), mhc], dim=-1)
    bot = torch.cat([mhc.transpose(-1, -2), mass[..., None, None] * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_matrix(X: Transform):
    """Dense 6x6 matrix of the motion transform."""
    E = X.E
    top = torch.cat([E, torch.zeros_like(E)], dim=-1)
    bot = torch.cat([-E @ hat(X.r), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def xform_inertia(X: Transform, I6):
    """Transform a 6x6 spatial inertia: I_child = X^{-T} I X^{-1} (motion X)."""
    Xi = motion_matrix(X.inv())
    return Xi.transpose(-1, -2) @ I6 @ Xi


def to_moby_gc(v6):
    """[ω; v] (Featherstone) -> [v; ω] (reference generalized-coordinate
    layout)."""
    return torch.cat([v6[..., 3:], v6[..., :3]], dim=-1)


def from_moby_gc(v6):
    """[v; ω] -> [ω; v]."""
    return torch.cat([v6[..., 3:], v6[..., :3]], dim=-1)
