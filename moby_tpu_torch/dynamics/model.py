"""Reduced-coordinate articulated body model (counterpart of
``moby_tpu/dynamics/model.py``).

A robot is a tree compiled host-side into static numpy tables:

* ``parent[i]`` — parent link index (-1 = world/base attachment),
* joint ``i`` connects ``parent[i]`` -> link ``i`` with a fixed tree
  transform (pose of the joint frame in the parent frame) and a typed motion
  subspace,
* per-link spatial inertia (6x6, link frame, [ω; v] Featherstone layout).

Joint types mirror the reference's concrete joints: fixed, revolute,
prismatic, spherical, universal, planar; a floating base is joint type
FLOATING on link 0. Generalized coordinates: revolute/prismatic 1; universal
2; planar 3; spherical 4 (unit quaternion, xyzw); floating 7 (xyz +
quaternion). Velocities: 1/1/2/3/3/6.

The functions take joint coordinates with a leading batch dimension, q
(B, nq), and return tensors of the caller's dtype and device; the loops over
links are Python loops over the static tree. The static tables stay numpy;
their tensors are made once per dtype and device (`const`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..math import quaternion as quat
from ..math import spatial as sp
from ..math.so3 import hat

# joint types
FIXED = 0
REVOLUTE = 1
PRISMATIC = 2
SPHERICAL = 3
UNIVERSAL = 4
PLANAR = 5
FLOATING = 6

NQ = {FIXED: 0, REVOLUTE: 1, PRISMATIC: 1, SPHERICAL: 4, UNIVERSAL: 2, PLANAR: 3, FLOATING: 7}
NV = {FIXED: 0, REVOLUTE: 1, PRISMATIC: 1, SPHERICAL: 3, UNIVERSAL: 2, PLANAR: 3, FLOATING: 6}


@dataclass
class JointDef:
    jtype: int
    # pose of the joint frame in the parent link's frame
    Xt_E: np.ndarray = None      # (3,3) rotation parent->joint coords
    Xt_r: np.ndarray = None      # (3,) joint origin in parent coords
    axis: np.ndarray = None      # (3,) axis in joint frame (rev/prism)
    axis2: np.ndarray = None     # (3,) second axis (universal)
    lo: np.ndarray = None        # lower limit(s)
    hi: np.ndarray = None        # upper limit(s)
    restitution: float = 0.0     # limit restitution (Moby `restitution-coeff`)
    # constant offset added to q inside the joint transform, so the reported
    # q keeps the user's chosen zero (Moby `q-tare`)
    tare: np.ndarray = None
    name: str = ""
    # tensors of the tables above, by (name, dtype, device) (`const`)
    _tensors: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class LinkDef:
    name: str
    mass: float
    com: np.ndarray              # (3,) in link frame
    inertia_com: np.ndarray      # (3,3) about COM
    joint: JointDef = None


class ArticulatedModel:
    """Host-compiled model: numpy tables, tensors made on use."""

    def __init__(self, links: List[LinkDef], floating: bool):
        self.nl = len(links)
        self.links = links
        self.floating = floating
        self.parent: List[int] = []
        self.jtype: List[int] = []
        self.q_off: List[int] = []
        self.v_off: List[int] = []
        q = v = 0
        for lk in links:
            self.jtype.append(lk.joint.jtype)
            self.q_off.append(q)
            self.v_off.append(v)
            q += NQ[lk.joint.jtype]
            v += NV[lk.joint.jtype]
        self.nq = q
        self.nv = v
        self.I_link = np.stack([
            sp.inertia_matrix(
                torch.tensor(float(lk.mass), dtype=torch.float64),
                torch.as_tensor(np.asarray(lk.com, np.float64)),
                torch.as_tensor(np.asarray(lk.inertia_com, np.float64)),
            ).numpy()
            for lk in links
        ])
        self._tensors = {}

    def set_parents(self, parent: List[int]):
        self.parent = list(parent)

    def neutral_q(self, dtype=np.float64):
        q = np.zeros(self.nq, dtype)
        for i in range(self.nl):
            if self.jtype[i] == SPHERICAL:
                q[self.q_off[i] + 3] = 1.0
            elif self.jtype[i] == FLOATING:
                q[self.q_off[i] + 6] = 1.0
        return q

    def link_inertia(self, i, dtype, device):
        return const(self, ("I_link", i), lambda: self.I_link[i], dtype, device)


def const(owner, key, make, dtype, device):
    """A static numpy table of `owner` (a JointDef or ArticulatedModel) as a
    tensor of `dtype` on `device`, made by `make()` once per key, dtype and
    device and kept on the owner."""
    k = (key, dtype, str(device))
    if k not in owner._tensors:
        owner._tensors[k] = torch.as_tensor(
            np.asarray(make(), np.float64), dtype=dtype, device=device)
    return owner._tensors[k]


def _axis_angle_matrix(axis, th):
    """Rotation matrix about unit axis (..., 3) by angle th (...)
    (Rodrigues)."""
    K = hat(axis)
    c = torch.cos(th)[..., None, None]
    s = torch.sin(th)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1 - c) * (K @ K)


def jcalc(jd: JointDef, jtype: int, q_j):
    """Joint transform X_J (child <- joint frame) and motion subspace
    S (B, 6, nv) expressed in the child (outboard) frame; q_j (B, nq)."""
    B = q_j.shape[0]
    dtype, device = q_j.dtype, q_j.device
    if jd.tare is not None and jtype in (REVOLUTE, PRISMATIC, UNIVERSAL, PLANAR):
        nq = q_j.shape[1]
        q_j = q_j + const(jd, ("tare", nq),
                          lambda: np.asarray(jd.tare).ravel()[:nq], dtype, device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    z3 = q_j.new_zeros((B, 3))
    if jtype == FIXED:
        return (sp.Transform(eye3.expand(B, 3, 3), z3),
                q_j.new_zeros((B, 6, 0)))
    if jtype == REVOLUTE:
        axis = const(jd, "axis", lambda: jd.axis, dtype, device)
        E = _axis_angle_matrix(axis, q_j[:, 0]).transpose(-1, -2)
        S = torch.cat([axis, axis.new_zeros(3)])[None, :, None].expand(B, 6, 1)
        return sp.Transform(E, z3), S
    if jtype == PRISMATIC:
        axis = const(jd, "axis", lambda: jd.axis, dtype, device)
        S = torch.cat([axis.new_zeros(3), axis])[None, :, None].expand(B, 6, 1)
        return sp.Transform(eye3.expand(B, 3, 3), axis * q_j[:, :1]), S
    if jtype == SPHERICAL:
        E = quat.to_matrix(q_j[:, :4]).transpose(-1, -2)
        S = torch.cat([eye3, torch.zeros_like(eye3)], dim=0)
        return sp.Transform(E, z3), S.expand(B, 6, 3)
    if jtype == UNIVERSAL:
        a1 = const(jd, "axis", lambda: jd.axis, dtype, device)
        a2_0 = const(jd, "axis2", lambda: jd.axis2, dtype, device)
        R1 = _axis_angle_matrix(a1, q_j[:, 0])
        a2 = (R1 @ a2_0)
        R2 = _axis_angle_matrix(a2, q_j[:, 1])
        E = (R2 @ R1).transpose(-1, -2)
        s1 = (E @ a1[:, None])[..., 0]
        s2 = (E @ a2[..., None])[..., 0]
        S = torch.stack([torch.cat([s1, z3], dim=-1),
                         torch.cat([s2, z3], dim=-1)], dim=-1)
        return sp.Transform(E, z3), S
    if jtype == PLANAR:
        # translation in joint x-y plane + rotation about joint z
        ez = eye3[2]
        E = _axis_angle_matrix(ez, q_j[:, 2]).transpose(-1, -2)
        r = torch.stack([q_j[:, 0], q_j[:, 1], q_j.new_zeros(B)], dim=-1)
        S = torch.stack([
            torch.cat([z3, E[..., :, 0]], dim=-1),
            torch.cat([z3, E[..., :, 1]], dim=-1),
            torch.cat([ez.expand(B, 3), z3], dim=-1),
        ], dim=-1)
        return sp.Transform(E, r), S
    if jtype == FLOATING:
        E = quat.to_matrix(q_j[:, 3:7]).transpose(-1, -2)
        S = torch.eye(6, dtype=dtype, device=device).expand(B, 6, 6)
        return sp.Transform(E, q_j[:, :3]), S
    raise ValueError(f"bad joint type {jtype}")


def compose(X2: sp.Transform, X1: sp.Transform) -> sp.Transform:
    """(X2 ∘ X1): apply X1 (outer/parent first), then X2."""
    E = X2.E @ X1.E
    r = X1.r + (X1.E.transpose(-1, -2) @ X2.r[..., None])[..., 0]
    return sp.Transform(E, r)


def joint_transforms(model: ArticulatedModel, q):
    """Per-link (X_up, S): X_up maps parent-frame spatial vectors to the link
    frame; S (B, 6, nv_i) is the motion subspace in the link frame."""
    Xs, Ss = [], []
    for i, lk in enumerate(model.links):
        jd = lk.joint
        qi = q[:, model.q_off[i]: model.q_off[i] + NQ[model.jtype[i]]]
        XJ, S = jcalc(jd, model.jtype[i], qi)
        Xt = sp.Transform(const(jd, "Xt_E", lambda: jd.Xt_E, q.dtype, q.device),
                          const(jd, "Xt_r", lambda: jd.Xt_r, q.dtype, q.device))
        # X_up = XJ ∘ Xt  (parent coords -> joint frame -> child frame)
        Xs.append(compose(XJ, Xt))
        Ss.append(S)
    return Xs, Ss


def link_world_poses(model: ArticulatedModel, q):
    """Forward kinematics: world pose (R_wl (B, 3, 3), p_wl (B, 3)) of each
    link."""
    Xs, _ = joint_transforms(model, q)
    Rs, ps = [], []
    for i in range(model.nl):
        X = Xs[i]
        # X: parent->link; world pose accumulates inverse transforms
        if model.parent[i] < 0:
            R = X.E.transpose(-1, -2)
            p = X.r
        else:
            Rp = Rs[model.parent[i]]
            pp = ps[model.parent[i]]
            R = Rp @ X.E.transpose(-1, -2)
            p = pp + (Rp @ X.r[..., None])[..., 0]
        Rs.append(R)
        ps.append(p)
    return Rs, ps


_JOINT_FIELDS = ("jtype", "Xt_E", "Xt_r", "axis", "axis2", "lo", "hi",
                 "restitution", "tare", "name")


def copy_model(m) -> ArticulatedModel:
    """An `ArticulatedModel` with the plain fields of `m`, a model of either
    package (its links' name, mass, com, inertia_com and joint fields, its
    parents and `floating`), read by attribute access."""
    def arr(x):
        return None if x is None else np.array(x, np.float64)

    links = []
    for lk in m.links:
        jd = lk.joint
        kw = {f: getattr(jd, f) for f in _JOINT_FIELDS}
        for f in ("Xt_E", "Xt_r", "axis", "axis2", "lo", "hi", "tare"):
            kw[f] = arr(kw[f])
        links.append(LinkDef(name=lk.name, mass=float(lk.mass), com=arr(lk.com),
                             inertia_com=arr(lk.inertia_com),
                             joint=JointDef(**kw)))
    out = ArticulatedModel(links, floating=bool(m.floating))
    out.set_parents([int(p) for p in m.parent])
    return out
