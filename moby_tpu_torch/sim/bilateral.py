"""Bilateral (implicit) constraints: gears and loop/point/planar joints
(counterpart of ``moby_tpu/sim/bilateral.py``).

The reference handles implicit bilateral joints in three places, all mirrored
here over the global generalized coordinates:

* forward dynamics solves the island KKT [M J'; J 0][a; λ] = [f; -J̇q̇]
  (`Simulator::solve`, src/Simulator.cpp:604-805);
* the impact handler replaces inv(M) by the constraint-projected
  X = iM − iM·J'·(J·iM·J')⁻¹·J·iM (`compute_X`,
  src/ImpactConstraintHandler.cpp:1590) and subtracts the λ-correction
  removing any pre-impact constraint-velocity violation
  (`update_from_stacked` :355-379);
* constraint stabilization projects the position-level violation C(q)
  (`ConstraintStabilization::evaluate_bilateral_constraints`).

Constraint types:
* GEAR — joint-velocity ratio coupling inside an articulated body
  (`Moby::Gears`, include/Moby/Gears.h:40-45): q̇_a − ratio·q̇_b = 0.
  Constant rows; the position form is identically zero.
* POINT — ball joint pinning anchor points of two bodies (3 equations).
  J from the current poses; J̇q̇ by forward-mode AD through the row builder.
* PLANAR — planar joint between two bodies (`Moby::PlanarJoint`): body A
  may translate in B's plane and rotate about its normal; 3 equations —
  relative velocity along the normal, relative angular velocity along both
  tangents. Position form: normal offset drift + small-angle tilt of the
  relative rotation.

Every array carries the batch of scenarios first: J is (B, NR, ngc) and C
(B, NR). The Gram matrix J·iM·J' gets the reference package's fixed
Tikhonov shift of 1e-12 and is factored by `torch.linalg.*_ex` without an
error check: a singular G gives non-finite numbers, never a host
synchronisation or an exception. In float32 the shift is below rounding, so
redundant constraints leave G singular there.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
import torch.autograd.forward_ad as fwAD

from ..core import scene as sc
from ..dynamics import model as amdl
from ..math import quaternion as quat
from ..math.so3 import hat, orthonormal_basis
from . import kinematics

GEAR = 0
POINT = 1
PLANAR = 2

REG = 1e-12


@dataclass(frozen=True)
class Bilateral:
    btype: int
    # GEAR: gc columns and ratio
    col_a: int = 0
    col_b: int = 0
    ratio: float = 1.0
    q_idx_a: int = 0
    q_idx_b: int = 0
    q0_a: float = 0.0
    q0_b: float = 0.0
    # POINT: pose slots + local anchors; PLANAR reuses the slots
    slot_a: int = 0
    slot_b: int = 0
    anchor_a: tuple = (0.0, 0.0, 0.0)
    anchor_b: tuple = (0.0, 0.0, 0.0)
    # PLANAR: plane normal in body B's (inboard) frame + initial offsets
    normal: tuple = (0.0, 1.0, 0.0)
    offset0: float = 0.0          # initial n·(p_a − p_b)
    qrel0: tuple = (0.0, 0.0, 0.0, 1.0)  # initial q_a ⊗ q_b⁻¹ (xyzw)

    @property
    def n_rows(self):
        return 1 if self.btype == GEAR else 3


def from_fields(b) -> Bilateral:
    """The port's `Bilateral` with the fields of `b`, a bilateral record of
    either package."""
    return Bilateral(**{f.name: getattr(b, f.name) for f in fields(Bilateral)})


def total_rows(scene: sc.Scene) -> int:
    return sum(b.n_rows for b in scene.bilaterals)


def _slot_W(W, s, B):
    """(B, 6, ngc) rows [v; ω] of pose slot s, for a shared or batched W."""
    return W[s].expand(B, -1, -1) if W.dim() == 3 else W[:, s]


def _vec(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(
        like.shape[0], len(x))


def _dot(a, b):
    return (a * b).sum(dim=-1)


def constraint_rows(scene: sc.Scene, st, pt):
    """(J (B, NR, ngc), C (B, NR)) at the current configuration."""
    B = pt.pos.shape[0]
    Js, Cs = [], []
    for b in scene.bilaterals:
        if b.btype == GEAR:
            row = pt.pos.new_zeros((B, 1, scene.ngc))
            row[:, 0, b.col_a] = 1.0
            row[:, 0, b.col_b] = -b.ratio
            Js.append(row)
            # position-level C is identically zero for gears
            # (Gears::evaluate_constraints, src/Gears.cpp:34-38)
            Cs.append(pt.pos.new_zeros((B, 1)))
        elif b.btype == POINT:
            xa, xb = pt.pos[:, b.slot_a], pt.pos[:, b.slot_b]
            pa = xa + quat.rotate(pt.quat[:, b.slot_a], _vec(b.anchor_a, xa))
            pb = xb + quat.rotate(pt.quat[:, b.slot_b], _vec(b.anchor_b, xb))
            # d/dt (pa - pb) = [I, -hat(ra)]·W_a - [I, -hat(rb)]·W_b
            Wa = _slot_W(pt.W, b.slot_a, B)
            Wb = _slot_W(pt.W, b.slot_b, B)
            Ja = Wa[:, :3] - hat(pa - xa) @ Wa[:, 3:]
            Jb = Wb[:, :3] - hat(pb - xb) @ Wb[:, 3:]
            Js.append(Ja - Jb)
            Cs.append(pa - pb)
        elif b.btype == PLANAR:
            qa, qb = pt.quat[:, b.slot_a], pt.quat[:, b.slot_b]
            n_w = quat.rotate(qb, _vec(b.normal, qb[:, :3]))
            t1, t2 = orthonormal_basis(n_w)
            Wa = _slot_W(pt.W, b.slot_a, B)
            Wb = _slot_W(pt.W, b.slot_b, B)
            dlin, dang = Wa[:, :3] - Wb[:, :3], Wa[:, 3:] - Wb[:, 3:]
            Js.append(torch.stack([
                (n_w[:, None] @ dlin)[:, 0],     # no relative motion along n
                (t1[:, None] @ dang)[:, 0],      # no tilt rate about t1
                (t2[:, None] @ dang)[:, 0],      # no tilt rate about t2
            ], dim=1))
            # position drift: normal offset + small-angle tilt of the
            # relative rotation vs its initial value
            c_n = _dot(n_w, pt.pos[:, b.slot_a] - pt.pos[:, b.slot_b]) - b.offset0
            q_rel = quat.mul(qa, quat.conj(qb))
            q_err = quat.mul(q_rel, quat.conj(_vec(b.qrel0, qa)))
            tilt = 2.0 * q_err[:, :3] * torch.sign(q_err[:, 3:4])
            Cs.append(torch.stack([c_n, _dot(t1, tilt), _dot(t2, tilt)], dim=1))
    if not Js:
        return pt.pos.new_zeros((B, 0, scene.ngc)), pt.pos.new_zeros((B, 0))
    return torch.cat(Js, dim=1), torch.cat(Cs, dim=1)


def jdot_qd(scene: sc.Scene, st):
    """J̇·q̇ (B, NR) for the acceleration-level KKT: forward-mode AD through
    the configuration-dependent rows along the current velocity."""
    NR = total_rows(scene)
    if NR == 0:
        return st.pos.new_zeros((st.pos.shape[0], 0))
    v = kinematics.gc_velocity(scene, st)
    qdot = quat.deriv(st.quat, st.omega)
    dq_art = _qdot_art(scene, st)
    with fwAD.dual_level():
        s = st.replace(pos=fwAD.make_dual(st.pos, st.vel),
                       quat=fwAD.make_dual(st.quat, qdot),
                       q_art=fwAD.make_dual(st.q_art, dq_art))
        J, _ = constraint_rows(scene, s, kinematics.compute(scene, s))
        out = fwAD.unpack_dual((J @ v[..., None])[..., 0]).tangent
    # constant rows (gears only) carry no tangent: J̇ = 0
    return st.pos.new_zeros((st.pos.shape[0], NR)) if out is None else out


def _qdot_art(scene, st):
    """d(q_art)/dt (B, nq_art) from qd_art (per joint type)."""
    if scene.nq_art == 0:
        return torch.zeros_like(st.q_art)
    segs = []
    for ent in scene.arts:
        m = ent.model
        for i in range(m.nl):
            t = m.jtype[i]
            qo = ent.q_off + m.q_off[i]
            vo = ent.v_off + m.v_off[i]
            if t in (amdl.REVOLUTE, amdl.PRISMATIC, amdl.UNIVERSAL, amdl.PLANAR):
                segs.append(st.qd_art[:, vo: vo + amdl.NQ[t]])
            elif t == amdl.SPHERICAL:
                segs.append(quat.deriv(st.q_art[:, qo: qo + 4],
                                       st.qd_art[:, vo: vo + 3]))
            elif t == amdl.FLOATING:
                qq = st.q_art[:, qo + 3: qo + 7]
                Rb = quat.to_matrix(qq)
                w_w = (Rb @ st.qd_art[:, vo: vo + 3, None])[..., 0]
                v_w = (Rb @ st.qd_art[:, vo + 3: vo + 6, None])[..., 0]
                segs.append(v_w)
                segs.append(quat.deriv(qq, w_w))
    return torch.cat(segs, dim=-1)


def _gram(Minv, J, reg):
    """(J·iM, J·iM·J' + reg·I)."""
    JM = J @ Minv
    eye = torch.eye(J.shape[-2], dtype=J.dtype, device=J.device)
    return JM, JM @ J.transpose(-1, -2) + reg * eye


def _solve(G, rhs):
    """G⁻¹·rhs (B, NR), with no error check (see the module docstring)."""
    return torch.linalg.solve_ex(G, rhs[..., None])[0]


def project_inv_inertia(Minv, J, reg=REG):
    """X = iM − iM·J'·(J·iM·J')⁻¹·J·iM (compute_X's projection)."""
    if J.shape[-2] == 0:
        return Minv
    JM, G = _gram(Minv, J, reg)
    Y = torch.linalg.inv_ex(G)[0]
    return Minv - JM.transpose(-1, -2) @ Y @ JM


def velocity_correction(Minv, J, v, reg=REG):
    """Δv (B, ngc) removing the bilateral constraint-velocity violation:
    −iM·J'·(J·iM·J')⁻¹·J·v (update_from_stacked's λ step)."""
    if J.shape[-2] == 0:
        return torch.zeros_like(v)
    JM, G = _gram(Minv, J, reg)
    lam = _solve(G, (J @ v[..., None])[..., 0])
    return -(JM.transpose(-1, -2) @ lam)[..., 0]


def acceleration_correction(Minv, J, a_free, jd_qd, reg=REG):
    """KKT acceleration: a = a_free − iM·J'·(J·iM·J')⁻¹·(J·a_free + J̇q̇)."""
    if J.shape[-2] == 0:
        return a_free
    JM, G = _gram(Minv, J, reg)
    lam = _solve(G, (J @ a_free[..., None])[..., 0] + jd_qd)
    return a_free - (JM.transpose(-1, -2) @ lam)[..., 0]


def position_correction(Minv, J, C, reg=REG):
    """Newton step (B, ngc) of the bilateral violation C(q) -> 0:
    −iM·J'·(J·iM·J')⁻¹·C (ConstraintStabilization's bilateral update)."""
    JM, G = _gram(Minv, J, reg)
    return -(JM.transpose(-1, -2) @ _solve(G, C))[..., 0]
