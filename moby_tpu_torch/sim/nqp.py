"""True-friction-cone (NQP) impact model (counterpart of
``moby_tpu/sim/nqp.py``).

Mirrors the reference's nonlinearly-constrained QP path
(`ImpactConstraintHandler::solve_nqp` / `solve_nqp_work`,
src/ImpactConstraintHandlerNQP.cpp:51-348, constraint functions in
src/NQP_IPOPT.cpp:311-470), selected when any contact uses an infinite
friction-cone edge count (`use_qp_solver`,
src/ImpactConstraintHandler.cpp:629-640):

    minimize    1/2 x' H x + c' x          x = [cn, cs, ct, l]
    subject to  cn >= 0, l >= 0
                Cn_blk x + Cn_v >= 0       (non-interpenetration)
                L_blk  x + L_v  >= 0       (joint limits)
                sum(Cn_blk x + Cn_v) <= kappa   (energy/kappa constraint)
                cs_i^2 + ct_i^2 <= mu_i^2 cn_i^2 + mu_visc_i   per contact

with H the Delassus operator over [Cn; Cs; Ct; L] rows, c the pre-impact
constraint velocities, mu_visc_i = (Cs_v_i^2 + Ct_v_i^2) * mu_viscous_i^2 and
kappa the total post-impact normal velocity of a frictionless LCP solve.

As in the reference package, the cone program is solved by a fixed-shape
augmented-Lagrangian / accelerated projected gradient (ALM-APGD) scheme
instead of the reference's IPOPT: a closed-form per-contact cone
projection, a fixed number of multiplier updates, step 1/L with L from a
fixed-count power method, Nesterov momentum with gradient restart. The trip
counts are fixed (no early exit), so the loop needs no host synchronisation;
every per-problem decision (the restart test, the norms, max|H|) is a (B,)
tensor, one per scenario. The frictionless pre-solve is an LCP through
`lcp.solve_lcp_fast_lemke`, whose card route runs the `ppm_lcp` kernel.
"""

from __future__ import annotations

import math

import torch

from .. import config as cfg
from ..core import scene as sc
from ..solvers import lcp
from .impact import ImpactResult, Problem, _active, _min_constraint_vel, assemble_problem

# fixed iteration budget (ALM outer x APGD inner)
OUTER_ITERS = 8
INNER_ITERS = 48
POWER_ITERS = 12


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _tr(A):
    return A.transpose(-1, -2)


def _build_hc(p: Problem):
    """Stack the Delassus operator H (B, n, n) and velocity vector c over
    [Cn; Cs; Ct; L] rows (src/ImpactConstraintHandlerNQP.cpp:157-241); the
    lower blocks are the transposes of the upper ones."""
    H = torch.cat([
        torch.cat([p.Ann, p.Ans, p.Ant, p.Anl], dim=2),
        torch.cat([_tr(p.Ans), p.Ass, p.Ast, p.Asl], dim=2),
        torch.cat([_tr(p.Ant), _tr(p.Ast), p.Att, p.Atl], dim=2),
        torch.cat([_tr(p.Anl), _tr(p.Asl), _tr(p.Atl), p.All], dim=2),
    ], dim=1)
    c = torch.cat([p.Cn_v, p.Cs_v, p.Ct_v, p.L_v], dim=1)
    return H, c


def _cone_projector(mu, k, act, all_mu_pos):
    """The Euclidean projection onto {cn >= 0, cs^2 + ct^2 <= mu^2 cn^2 + k},
    elementwise over (B, K), as a function of (n, s, t); the terms that do
    not change between the solver's iterations are made here, once.

    For k = 0 this is the exact second-order-cone projection. For k > 0
    (viscous friction floor, NQP_IPOPT::eval_g :419) the set is a hyperboloid
    shell; the substitution n~ = sqrt(n^2 + k/mu^2) maps it to the cone
    r <= mu n~, which is projected onto and mapped back — exact at k = 0.
    `all_mu_pos` (a host-side fact of the scene) drops the mu == 0 branch.
    The reference package's `polar` case (mu·r <= -n~) gives n~ = 0 where
    its other branch gives (n~ + mu·r)/(1 + mu^2) = 0 too, so it is left out.
    """
    eps = 1e-30
    mu = mu.clamp_min(0.0)
    pos_mu = mu > 0
    shift = torch.where(pos_mu, k / (mu * mu).clamp_min(eps), 0.0)
    one_mu2 = 1.0 + mu * mu
    rad0 = torch.sqrt(k.clamp_min(0.0))
    m = act.to(k.dtype)

    def project(n, s, t):
        n = n.clamp_min(0.0)
        r = torch.sqrt(s * s + t * t + eps)
        # mu > 0: shifted SOC projection
        nt = torch.sqrt(n * n + shift)
        inside = r <= mu * nt
        nt_p = (nt + mu * r) / one_mu2
        scale = torch.where(inside, 1.0, mu * nt_p / r)
        n_out = torch.sqrt((nt_p * nt_p - shift).clamp_min(0.0))
        n_new = torch.where(inside, n, n_out)
        if all_mu_pos:
            return n_new * m, s * scale * m, t * scale * m
        # mu == 0: ball of radius sqrt(k) in the tangent plane
        scale0 = torch.clamp(rad0 / r, max=1.0)
        scale = torch.where(pos_mu, scale, scale0)
        return (torch.where(pos_mu, n_new, n) * m, s * scale * m,
                t * scale * m)

    return project


def _kappa(p: Problem, act, act_lim, skip=None, cascade=None):
    """Frictionless LCP pre-solve; kappa (B,) = total post-impact normal
    velocity (`solve_lcp`, src/ImpactConstraintHandler.cpp:1480-1527)."""
    K = p.Cn_v.shape[1]
    MM = torch.cat([torch.cat([p.Ann, p.Anl], dim=2),
                    torch.cat([_tr(p.Anl), p.All], dim=2)], dim=1)
    qq = torch.cat([p.Cn_v, p.L_v], dim=1)
    mask = torch.cat([act, act_lim], dim=1)
    z, _, stats = lcp.solve_lcp_fast_lemke(
        MM, qq, mask, skip=skip, with_stats=True, cascade=cascade)
    vplus = _mv(p.Ann, z[:, :K]) + _mv(p.Anl, z[:, K:]) + p.Cn_v
    return torch.where(act, vplus, 0.0).sum(dim=1), stats


def solve_nqp(scene: sc.Scene, p: Problem, act, act_lim, skip=None,
              cascade=None):
    """One NQP solve of every scenario. Returns (cn, cs, ct, l, dv, stats);
    stats counts the kappa pre-solve's LCP pivots plus the fixed ALM-APGD
    iteration effort."""
    K = scene.n_contacts
    dtype = p.Ann.dtype
    B = p.Ann.shape[0]

    H, c = _build_hc(p)
    n = H.shape[-1]
    vmask = torch.cat([act, act, act, act_lim], dim=1).to(dtype)
    H = H * vmask[:, :, None] * vmask[:, None, :]
    c = c * vmask

    k_visc = (p.Cs_v ** 2 + p.Ct_v ** 2) * scene.slot_mu_v ** 2
    cone = _cone_projector(scene.slot_mu_c, k_visc, act,
                           bool((scene.host["slot_mu_c"] > 0).all()))

    kap, kap_stats = _kappa(p, act, act_lim, skip=skip, cascade=cascade)

    # linear inequalities A x + b >= 0:
    #   rows 0..K:      post-impact normal velocities  (Cn_blk = H[:K])
    #   rows K..K+NL:   post-impact limit velocities   (L_blk = H[3K:])
    #   last row:       kappa - sum of normal velocities
    Hn = H[:, :K]
    Hl = H[:, 3 * K:]
    A = torch.cat([Hn, Hl, -Hn.sum(dim=1, keepdim=True)], dim=1)
    b = torch.cat([p.Cn_v, p.L_v,
                   (kap - torch.where(act, p.Cn_v, 0.0).sum(dim=1))[:, None]],
                  dim=1)
    cmask = torch.cat([act, act_lim, act.any(dim=1, keepdim=True)],
                      dim=1).to(dtype)
    A = A * cmask[:, :, None]
    b = torch.where(cmask > 0, b, 1.0)  # inert rows: trivially satisfied
    At = _tr(A)

    # penalty weight on the Delassus scale, per scenario
    rho = H.abs().amax(dim=(1, 2)).clamp_min(1e-12)[:, None]

    def op(v):
        return _mv(H, v) + rho * _mv(At, _mv(A, v))

    # Lipschitz bound for grad(f + quadratic penalty) by power iteration on
    # H + rho A'A (fixed POWER_ITERS sweeps)
    v = H.new_full((B, n), 1.0 / math.sqrt(n))
    for _ in range(POWER_ITERS):
        w = op(v)
        v = w / torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-30)
    L = torch.linalg.vector_norm(op(v), dim=1, keepdim=True) * 1.2 + 1e-12
    step = 1.0 / L

    lim_m = act_lim.to(dtype)

    def project(x):
        cn, cs, ct = cone(x[:, :K], x[:, K: 2 * K], x[:, 2 * K: 3 * K])
        return torch.cat([cn, cs, ct, x[:, 3 * K:].clamp_min(0.0) * lim_m], dim=1)

    def grad(x, lam):
        sgap = _mv(A, x) + b
        pen = (lam - rho * sgap).clamp_min(0.0)  # PHR multiplier estimate
        return _mv(H, x) + c - _mv(At, pen)

    x = H.new_zeros((B, n))
    lam = H.new_zeros((B, A.shape[1]))
    for _ in range(OUTER_ITERS):
        y = x
        for i in range(INNER_ITERS):
            x_new = project(y - step * grad(y, lam))
            # gradient restart: kill momentum when it points uphill
            uphill = ((y - x_new) * (x_new - x)).sum(dim=1, keepdim=True) > 0
            mom = (~uphill).to(dtype) * (i / (i + 3.0))
            y = x_new + mom * (x_new - x)
            x = x_new
        lam = (lam - rho * (_mv(A, x) + b)).clamp_min(0.0) * cmask
    x = project(x)

    cn, cs, ct, lz = x[:, :K], x[:, K: 2 * K], x[:, 2 * K: 3 * K], x[:, 3 * K:]
    w = (_mv(_tr(p.Jn), cn) + _mv(_tr(p.Js), cs) + _mv(_tr(p.Jt), ct)
         + _mv(_tr(p.Jl), lz))
    dv = _mv(p.Minv, w)
    ran = torch.ones(B, dtype=torch.bool, device=H.device) if skip is None else ~skip
    if skip is not None:
        keep = ~skip[:, None]
        cn, cs, ct, lz, dv = (torch.where(keep, a, 0.0) for a in (cn, cs, ct, lz, dv))
    stats = lcp.LCPStats(
        pivots=kap_stats.pivots + torch.where(ran, INNER_ITERS * OUTER_ITERS, 0).to(
            kap_stats.pivots.dtype),
        fallback=kap_stats.fallback,
    )
    return cn, cs, ct, lz, dv, stats


def resolve_impacts_nqp(
    scene: sc.Scene, st, pt, con, zlast, zlast_active,
    act_filter=None, lim_filter=None, cascade=None,
) -> ImpactResult:
    """Full NQP pipeline with Poisson restitution + conditional re-solve
    (`apply_model`'s solve_nqp branch + `apply_restitution`,
    src/ImpactConstraintHandler.cpp:562-602). `cascade` is handed to the
    kappa pre-solves (see `solvers.lcp`)."""
    nz = cfg.near_zero(st.pos.dtype)

    act, act_lim, _, _ = _active(scene, st, pt, con, nz)
    if act_filter is not None:
        act = act & act_filter
    if lim_filter is not None and scene.n_limits:
        act_lim = act_lim & lim_filter
    any_impact = act.any(dim=1) | act_lim.any(dim=1)

    p = assemble_problem(scene, st, pt, con, act, act_lim)
    cn1, cs1, ct1, l1, dv1, st1 = solve_nqp(scene, p, act, act_lim,
                                            cascade=cascade)

    Cn_v1 = (p.Cn_v + _mv(p.Ann, cn1) + _mv(p.Ans, cs1) + _mv(p.Ant, ct1)
             + _mv(p.Anl, l1))
    L_v1 = (p.L_v + _mv(_tr(p.Anl), cn1) + _mv(_tr(p.Asl), cs1)
            + _mv(_tr(p.Atl), ct1) + _mv(p.All, l1))
    minv = _min_constraint_vel(Cn_v1, act, L_v1, act_lim)

    # restitution: cn, l scale; tangentials kept (apply_restitution,
    # src/ImpactConstraintHandler.cpp:496-524)
    cn2 = cn1 * scene.slot_eps
    l2 = l1 * scene.lim_eps
    changed = (cn2 > nz).any(dim=1) | (l2 > nz).any(dim=1)

    dv2 = _mv(p.Minv, _mv(_tr(p.Jn), cn2) + _mv(_tr(p.Jl), l2))
    Cn_v2 = Cn_v1 + _mv(p.Ann, cn2) + _mv(p.Anl, l2)
    L_v2 = L_v1 + _mv(_tr(p.Anl), cn2) + _mv(p.All, l2)
    minv_plus = _min_constraint_vel(Cn_v2, act, L_v2, act_lim)
    need_resolve = changed & (minv_plus < 0.0) & (minv_plus < minv - nz)

    p2 = p._replace(
        Cn_v=Cn_v2,
        Cs_v=p.Cs_v + _mv(p.Js, dv1 + dv2),
        Ct_v=p.Ct_v + _mv(p.Jt, dv1 + dv2),
        L_v=L_v2,
    )
    cn3, _, _, _, dv3, st3 = solve_nqp(
        scene, p2, act, act_lim, skip=~need_resolve, cascade=cascade)

    nr, ch, ai = need_resolve[:, None], changed[:, None], any_impact[:, None]
    dv = torch.where(nr, dv1 + dv2 + dv3, torch.where(ch, dv1 + dv2, dv1))
    cn_total = cn1 + torch.where(ch, cn2, 0.0) + torch.where(nr, cn3, 0.0)
    pivots = torch.where(any_impact, st1.pivots + st3.pivots, 0).to(torch.int32)
    fallbacks = st1.fallback.to(torch.int32) + st3.fallback.to(torch.int32)
    return ImpactResult(torch.where(ai, dv, 0.0), zlast,
                        torch.where(ai, act, zlast_active),
                        torch.where(ai, cn_total, 0.0), pivots, fallbacks)
