"""Post-step constraint stabilization (position projection); counterpart of
``moby_tpu/sim/stabilization.py``.

Mirrors `ConstraintStabilization::stabilize` (src/ConstraintStabilization.cpp:167):
while the minimum pairwise signed distance or joint-limit slack is below
eps (= NEAR_ZERO), or a bilateral constraint is violated by more than 1e-6,
solve a position-level LCP over the stacked contact-normal and limit
Jacobians Q = [Cn; L]

    Q·inv(M)·Q' z + (slack - |eps| - NEAR_ZERO) >= 0,  z >= 0

(the reference's `determine_dq`, :932), add the Newton projection of the
bilateral violation C(q) -> 0, and move the configuration by the resulting
generalized displacement. The reference guards the update with a Ridders'
line search so no *new* violation is introduced; here the guard is a
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
from . import bilateral as bil
from . import impact
from . import kinematics

MAX_STAB_ITERS = 50   # safety cap; the loop is violation-driven


def _limit_violation(scene, s):
    """Signed joint-limit slack (B, NL), >= 0 when satisfied: hi - q or
    q - lo."""
    q = s.q_art[:, scene.lim_q_idx]
    return torch.where(scene.lim_upper, scene.lim_value - q, q - scene.lim_value)


def stabilize(scene: sc.Scene, st: sc.State, cascade=None) -> sc.State:
    dtype = st.pos.dtype
    nz = cfg.near_zero(dtype)
    from .stepper import integrate_art_q

    if scene.n_contacts == 0 and scene.n_limits == 0 and not scene.bilaterals:
        return st
    if scene.stab_max_iters == 0:
        # disabled (XML constraint-stabilization-max-iterations="0")
        return st
    B = st.pos.shape[0]
    nb = scene.nb
    K = scene.n_contacts

    def min_dist(s):
        vals = [s.pos.new_full((B, 1), torch.inf), _limit_violation(scene, s)]
        if scene.n_pairs:
            pt = kinematics.compute(scene, s)
            pd, _ = nph.narrow_phase(scene, pt.pos, pt.quat, nz)
            vals.append(pd.dist)
        return torch.cat(vals, dim=1).amin(dim=1)

    def bilateral_vio(s):
        """max |C(q)| (B,) of the bilateral constraints."""
        if not scene.bilaterals:
            return s.pos.new_zeros(B)
        _, C = bil.constraint_rows(scene, s, kinematics.compute(scene, s))
        return C.abs().amax(dim=1)

    s = st
    for _ in range(min(MAX_STAB_ITERS, scene.stab_max_iters)):
        # while (max_uvio < eps || max_bvio > bilateral_eps), :197 — per
        # scenario
        active = (min_dist(s) < nz) | (bilateral_vio(s) > 1e-6)
        if not bool(active.any()):
            break
        pt = kinematics.compute(scene, s)
        if K or scene.n_limits:
            _, con = nph.narrow_phase(scene, pt.pos, pt.quat, torch.inf)
            act = con.active & torch.isfinite(con.depth)
            all_lim = act.new_ones((B, scene.n_limits))

            p = impact.assemble_problem(scene, s, pt, con, act, all_lim)
            # stacked [contacts; limits] position LCP (determine_dq:932)
            MM = torch.cat([torch.cat([p.Ann, p.Anl], dim=2),
                            torch.cat([p.Anl.transpose(-1, -2), p.All], dim=2)],
                           dim=1)
            qq = torch.cat([con.depth - abs(nz) - nz,
                            _limit_violation(scene, s) - abs(nz) - nz], dim=1)
            mact = torch.cat([act, all_lim], dim=1)
            z, _ok = lcp.solve_lcp_fast_lemke(MM, qq, mact, cascade=cascade)

            # generalized displacement dq = inv(M) [Cn' L'] z
            w = (p.Jn.transpose(-1, -2) @ z[:, :K, None]
                 + p.Jl.transpose(-1, -2) @ z[:, K:, None])
            dv = (p.Minv @ w)[..., 0]
        else:
            dv = s.pos.new_zeros((B, scene.ngc))
        if scene.bilaterals:
            # Newton projection of the bilateral violation C(q) -> 0
            Jb, C = bil.constraint_rows(scene, s, pt)
            dv = dv + bil.position_correction(
                impact.gc_inv_inertia(scene, s, s.quat), Jb, C)

        def apply_dq(s0, t):
            s2 = s0
            if nb:
                dvb = dv[:, : 6 * nb].reshape(B, nb, 6) * t
                s2 = s2.replace(
                    pos=s0.pos + dvb[..., :3],
                    quat=quat.normalize(s0.quat + quat.deriv(s0.quat, dvb[..., 3:])))
            if scene.nv_art:
                s2 = s2.replace(q_art=integrate_art_q(
                    scene, s0.q_art, dv[:, 6 * nb:], t))
            return s2

        # backtracking guard (Ridders analog): try the full projection step
        # first, halve while it makes the worst violation worse. The slack is
        # the min signed distance, netted against the bilateral drift (both
        # are what the reference's loop monitors).
        cands = [apply_dq(s, t) for t in (1.0, 0.5, 0.25)]
        scores = torch.stack(
            [torch.minimum(min_dist(c), nz - bilateral_vio(c)) for c in cands],
            dim=1)
        best = torch.argmax(scores, dim=1)   # first (largest t) wins ties
        ar = torch.arange(B, device=best.device)
        pick = {}
        for name in ("pos", "quat", "q_art"):
            stacked = torch.stack([getattr(c, name) for c in cands], dim=1)
            old = getattr(s, name)
            pick[name] = torch.where(
                active.reshape((B,) + (1,) * (old.dim() - 1)),
                stacked[ar, best], old)
        s = s.replace(**pick)
    return s
