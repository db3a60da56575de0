"""No-slip impact model: infinite Coulomb friction (counterpart of
``moby_tpu/sim/noslip.py``).

Mirrors `ImpactConstraintHandler::apply_no_slip_model`
(src/ImpactConstraintHandler.cpp:1009-1420), used when every contact has
mu_coulomb >= 100 (`apply_model` :123-131):

MLCP with hard tangential constraints (S, T rows) condensed blockwise:

    A = [M X'; X 0],  X = [S_sel; T_sel],  Y = X·inv(M)·X'
    LCP over [cn; l]:  MM = Q·inv(M)·Q' − QX·Y^{-1}·QX'
                       qq = [Cn_v; L_v] − QX·Y^{-1}·X·v

with a greedy full-rank selection of S/T rows (one contact at a time,
testing Cholesky success of the de-regularized Gram matrix — :1092-1145),
`lcp_fast` with `lcp_lemke_regularized` fallback (`solve_lcp_fast_lemke`,
whose accelerated cascade reaches the PPM kernel on the card), and
tangential impulses recovered as cs,ct = −Y^{-1}(X·v + X·inv(M)·Q'·[cn; l]).

Restitution (the no-slip variant `apply_restitution(epd)`): cn, l scale by
epsilon, cs, ct reset to zero; conditional second solve.

Batched form: the greedy selection is a fixed loop over the K contact slots
updating (B, K) boolean masks, two masked Cholesky probes of the (B, 2K, 2K)
Gram matrix per slot, with no host synchronisation; every solve is masked
and fixed-shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as cfg
from ..core import scene as sc
from ..math.linalg import _masked_system, cholesky_ok
from ..solvers import lcp
from .impact import (
    ImpactResult,
    Problem,
    _active,
    _min_constraint_vel,
    assemble_problem,
)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _tr(A):
    return A.transpose(-1, -2)


def _st_gram(p: Problem, sS, sT):
    """Masked Gram matrix [[Css(S,S), Cst(S,T)], [., Ctt(T,T)]] as a
    (B, 2K, 2K) block with rows/cols [S slots; T slots], and its mask."""
    top = torch.cat([p.Ass, p.Ast], dim=2)
    bot = torch.cat([_tr(p.Ast), p.Att], dim=2)
    return torch.cat([top, bot], dim=1), torch.cat([sS, sT], dim=1)


def select_st_indices(p: Problem, act, near_zero):
    """Greedy full-rank S/T row selection (reference :1092-1145):
    (sS, sT), each (B, K)."""
    K = p.Ass.shape[-1]
    sS = torch.zeros_like(act)
    sT = torch.zeros_like(act)
    G, _ = _st_gram(p, sS, sT)
    for i in range(K):
        eligible = act[:, i]
        sS_try = sS.clone()
        sS_try[:, i] = eligible
        ok_s = cholesky_ok(G, mask=torch.cat([sS_try, sT], dim=1), jitter=-near_zero)
        sS = torch.where((ok_s & eligible)[:, None], sS_try, sS)

        sT_try = sT.clone()
        sT_try[:, i] = eligible
        ok_t = cholesky_ok(G, mask=torch.cat([sS, sT_try], dim=1), jitter=-near_zero)
        sT = torch.where((ok_t & eligible)[:, None], sT_try, sT)
    return sS, sT


def solve_noslip(scene: sc.Scene, p: Problem, act, act_lim, nz, skip=None,
                 cascade=None):
    """One no-slip solve. Returns (cn, cs, ct, l, dv, stats)."""
    K = scene.n_contacts

    sS, sT = select_st_indices(p, act, nz)
    G, gmask = _st_gram(p, sS, sT)
    # Y = G restricted to the selected rows: one Cholesky serves every
    # Y^{-1} application below
    L = torch.linalg.cholesky_ex(_masked_system(G, gmask))[0]

    def Yinv(rhs):
        """Y^{-1} applied to the columns of rhs (B, 2K, r); zero outside the
        selection."""
        x = torch.cholesky_solve(torch.where(gmask[..., None], rhs, 0.0), L)
        return torch.where(gmask[..., None], x, 0.0)

    # Q·inv(M)·X' with X = [S; T]: rows [Cn; L] x cols [S slots; T slots]
    QX = torch.cat([torch.cat([p.Ans, p.Ant], dim=2),
                    torch.cat([_tr(p.Asl), _tr(p.Atl)], dim=2)], dim=1)
    QX = QX * gmask[:, None, :].to(QX.dtype)                  # (B, K+NL, 2K)

    Xv = torch.cat([p.Cs_v, p.Ct_v], dim=1) * gmask.to(QX.dtype)
    YinvXv = Yinv(Xv[..., None])[..., 0]

    # MM = Q iM Q' − QX Y^{-1} QX'
    Qblocks = torch.cat([torch.cat([p.Ann, p.Anl], dim=2),
                         torch.cat([_tr(p.Anl), p.All], dim=2)], dim=1)
    MM = Qblocks - QX @ Yinv(_tr(QX))
    qq = torch.cat([p.Cn_v, p.L_v], dim=1) - _mv(QX, YinvXv)

    vmask = torch.cat([act, act_lim], dim=1)
    v_sol, _ok, stats = lcp.solve_lcp_fast_lemke(
        MM, qq, vmask, skip=skip, with_stats=True, cascade=cascade)

    cn = v_sol[:, :K]
    l = v_sol[:, K:]

    # [cs; ct] on selected rows = −Y^{-1}(X v + X iM Q' [cn; l])
    cs_ct = -(YinvXv + Yinv(_mv(_tr(QX), v_sol)[..., None])[..., 0])
    cs = torch.where(sS, cs_ct[:, :K], 0.0)
    ct = torch.where(sT, cs_ct[:, K:], 0.0)

    w = (_mv(_tr(p.Jn), cn) + _mv(_tr(p.Js), cs) + _mv(_tr(p.Jt), ct)
         + _mv(_tr(p.Jl), l))
    return cn, cs, ct, l, _mv(p.Minv, w), stats


def resolve_impacts_noslip(
    scene: sc.Scene, st, pt, con, zlast, zlast_active,
    act_filter=None, lim_filter=None, cascade=None,
) -> ImpactResult:
    """Full no-slip pipeline (apply_no_slip_model_to_connected_constraints,
    src/ImpactConstraintHandler.cpp:236-295). `cascade` is handed to the LCP
    solves (see `solvers.lcp`)."""
    nz = cfg.near_zero(st.pos.dtype)

    act, act_lim, _, _ = _active(scene, st, pt, con, nz)
    if act_filter is not None:
        act = act & act_filter
    if lim_filter is not None and scene.n_limits:
        act_lim = act_lim & lim_filter
    any_impact = act.any(dim=1) | act_lim.any(dim=1)

    p = assemble_problem(scene, st, pt, con, act, act_lim)
    # nothing impacting -> dv is zeroed below; skip the pivot loops
    cn1, cs1, ct1, l1, dv1, st1 = solve_noslip(
        scene, p, act, act_lim, nz, skip=~any_impact, cascade=cascade)

    ai = any_impact[:, None]
    za_out = torch.where(ai, act, zlast_active)
    # Every restitution coefficient zero (static): cn and l scale to zero,
    # nothing changes and dv == dv1, so the second selection and solve,
    # whose results the JAX package discards in that case, are not made.
    if (float(np.max(scene.host["slot_eps"], initial=0.0)) == 0.0
            and float(np.max(scene.host["lim_eps"], initial=0.0)) == 0.0):
        return ImpactResult(
            torch.where(ai, dv1, 0.0), zlast, za_out, torch.where(ai, cn1, 0.0),
            st1.pivots.to(torch.int32), st1.fallback.to(torch.int32))

    Cn_v1 = (p.Cn_v + _mv(p.Ann, cn1) + _mv(p.Ans, cs1) + _mv(p.Ant, ct1)
             + _mv(p.Anl, l1))
    L_v1 = (p.L_v + _mv(_tr(p.Anl), cn1) + _mv(_tr(p.Asl), cs1)
            + _mv(_tr(p.Atl), ct1) + _mv(p.All, l1))
    minv = _min_constraint_vel(Cn_v1, act, L_v1, act_lim)

    # restitution: cn,l scale; cs,ct zero (apply_restitution(epd), :496-524)
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
    # the second solve only matters when restitution re-triggers impacts
    cn3, _, _, _, dv3, st3 = solve_noslip(
        scene, p2, act, act_lim, nz, skip=~need_resolve, cascade=cascade)

    nr, ch = need_resolve[:, None], changed[:, None]
    dv = torch.where(nr, dv1 + dv2 + dv3, torch.where(ch, dv1 + dv2, dv1))
    cn_total = cn1 + torch.where(ch, cn2, 0.0) + torch.where(nr, cn3, 0.0)
    pivots = (st1.pivots + st3.pivots).to(torch.int32)
    fallbacks = st1.fallback.to(torch.int32) + st3.fallback.to(torch.int32)
    return ImpactResult(torch.where(ai, dv, 0.0), zlast, za_out,
                        torch.where(ai, cn_total, 0.0), pivots, fallbacks)
