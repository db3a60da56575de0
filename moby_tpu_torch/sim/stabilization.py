"""Post-step constraint stabilization (position projection); counterpart of
``moby_tpu/sim/stabilization.py``.

Mirrors `ConstraintStabilization::stabilize` (src/ConstraintStabilization.cpp:167):
while the minimum pairwise signed distance is below eps (= NEAR_ZERO), solve a
position-level LCP over the contact-normal Jacobians

    Cn·inv(M)·Cn' z + (dist - |eps| - NEAR_ZERO) >= 0,  z >= 0

(the reference's `determine_dq`, :932) and move the configuration by the
resulting generalized displacement. The reference guards the update with a
Ridders' line search so no *new* violation is introduced; here the guard is a
fixed-candidate backtracking select (t in {1, 1/2, 1/4}, keep the step with
the largest post-step violation slack, largest t on ties). The loop is
violation-driven per scenario with a deep safety cap: a masked batched loop
that ends when no scenario violates (one host synchronisation per
iteration). Velocities untouched.
"""

from __future__ import annotations

import torch

from .. import config as cfg
from ..core import scene as sc
from ..geometry import narrowphase as nph
from ..math import quaternion as quat
from ..solvers import lcp
from . import impact
from . import kinematics

MAX_STAB_ITERS = 50   # safety cap; the loop is violation-driven


def stabilize(scene: sc.Scene, st: sc.State, cascade=None) -> sc.State:
    dtype = st.pos.dtype
    nz = cfg.near_zero(dtype)
    if scene.n_limits or scene.bilaterals:
        raise NotImplementedError(
            "joint limits and bilateral constraints are not ported yet")
    if scene.n_contacts == 0:
        return st
    if scene.stab_max_iters == 0:
        # disabled (XML constraint-stabilization-max-iterations="0")
        return st
    B = st.pos.shape[0]
    nb = scene.nb

    def min_dist(s):
        if not scene.n_pairs:
            return s.pos.new_full((B,), torch.inf)
        pt = kinematics.compute(scene, s)
        pd, _ = nph.narrow_phase(scene, pt.pos, pt.quat, nz)
        return pd.dist.amin(dim=1)

    s = st
    for _ in range(min(MAX_STAB_ITERS, scene.stab_max_iters)):
        # while (max_uvio < eps), :197 — per scenario
        active = min_dist(s) < nz
        if not bool(active.any()):
            break
        pt = kinematics.compute(scene, s)
        _, con = nph.narrow_phase(scene, pt.pos, pt.quat, torch.inf)
        act = con.active & torch.isfinite(con.depth)
        no_lim = act.new_zeros((B, 0))

        p = impact.assemble_problem(scene, s, pt, con, act, no_lim)
        # position LCP over the contact normals (determine_dq:932)
        MM = p.Ann.contiguous()
        qq = con.depth - abs(nz) - nz
        z, _ok = lcp.solve_lcp_fast_lemke(MM, qq, act, cascade=cascade)

        # generalized displacement dq = inv(M) Cn' z
        w = p.Jn.transpose(-1, -2) @ z[..., None]
        dv = (p.Minv @ w)[..., 0]

        def apply_dq(s0, t):
            dvb = dv[:, : 6 * nb].reshape(B, nb, 6) * t
            newpos = s0.pos + dvb[..., :3]
            newquat = quat.normalize(
                s0.quat + quat.deriv(s0.quat, dvb[..., 3:]))
            return s0.replace(pos=newpos, quat=newquat)

        # backtracking guard (Ridders analog): try the full projection step
        # first, halve while it makes the worst violation worse. The slack is
        # the min signed distance, capped at NEAR_ZERO.
        cands = [apply_dq(s, t) for t in (1.0, 0.5, 0.25)]
        scores = torch.stack(
            [min_dist(c).clamp_max(nz) for c in cands], dim=1)
        best = torch.argmax(scores, dim=1)   # first (largest t) wins ties
        pos_c = torch.stack([c.pos for c in cands], dim=1)
        quat_c = torch.stack([c.quat for c in cands], dim=1)
        ar = torch.arange(B, device=best.device)
        sel = active[:, None, None]
        s = s.replace(
            pos=torch.where(sel, pos_c[ar, best], s.pos),
            quat=torch.where(sel, quat_c[ar, best], s.quat),
        )
    return s
