"""Impact/impulse resolution: the Drumwright–Shell QP-as-LCP model
(counterpart of ``moby_tpu/sim/impact.py``).

Mirrors the reference's live solver path
(`ImpactConstraintHandler::apply_model`, src/ImpactConstraintHandler.cpp:96):

1. connected constraint groups over enabled bodies (islands), dropping groups
   with no impacting constraint;
2. contact and joint-limit Jacobians over the generalized coordinates and
   all Delassus cross blocks (`compute_problem_data`, :1898+): free bodies
   are 6-dof blocks, articulated bodies couple through their joint-space
   mass matrix H(q) (X = inv(M), compute_X :1590);
3. the QP stacked as a monolithic KKT LCP `[[H, -M'], [M, 0]]`
   (`setup_QP` + `solve_qp_work`, src/ImpactConstraintHandlerQP.cpp:94-499)
   solved by the `lcp.solve_lcp` cascade, warm-started from the previous
   step's solution (`_zlast`);
4. Poisson restitution with the conditional second impact solve
   (`apply_restitution` + re-solve, :577-602).

One *joint* LCP over all islands instead of per-island solves: for the convex
QP model the two are trajectory-equivalent. Scenes whose islands disagree on
the impact model route each island to its own (`model_masks`). With
bilateral constraints, inv(M) becomes the constraint-projected X and the
λ-correction removes any constraint-velocity violation (`sim.bilateral`).
Every array carries the batch as its leading dimension; the scene's tables
are shared.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import config as cfg
from ..core import scene as sc
from ..geometry.narrowphase import Contacts
from ..math import quaternion as quat
from ..solvers import lcp
from ..dynamics import aba as art_dyn
from . import bilateral as bil
from .kinematics import PoseTable, gc_velocity, wrench_rows


class ImpactResult(NamedTuple):
    dv: torch.Tensor          # (B, ngc) total velocity change
    zlast: torch.Tensor
    zlast_active: torch.Tensor
    impulses_n: torch.Tensor  # (B, K)
    pivots: torch.Tensor = None     # (B,) int32: LCP pivot count of this solve
    fallbacks: torch.Tensor = None  # (B,) int32: solver-cascade fallback count
    # the LCP solution actually applied THIS step (zero when the solve was
    # gated out) — unlike zlast, which passes the warm-start seed through on
    # no-impact steps
    z_step: torch.Tensor = None


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def contact_velocities(scene: sc.Scene, pt: PoseTable, con: Contacts):
    """Per-slot relative velocity of body1's material point minus body2's,
    projected on (n, t1, t2) (UnilateralConstraint::calc_constraint_vel)."""
    s1, s2 = con.s1, con.s2
    r1 = con.point - pt.pos[:, s1]
    r2 = con.point - pt.pos[:, s2]
    vp1 = pt.vel[:, s1] + _cross(pt.omega[:, s1], r1)
    vp2 = pt.vel[:, s2] + _cross(pt.omega[:, s2], r2)
    rv = vp1 - vp2
    return (
        torch.sum(rv * con.normal, dim=-1),
        torch.sum(rv * con.tan1, dim=-1),
        torch.sum(rv * con.tan2, dim=-1),
    )


def island_labels(scene: sc.Scene, active):
    """Connected components over *enabled* pose slots through active
    contacts; links of one articulated body are always mutually connected
    (src/UnilateralConstraint.cpp:958-1065), and so are the two bodies of a
    point joint. Disabled bodies are not nodes. active (B, K) -> labels
    (B, ns)."""
    ns = scene.n_pose_slots
    B = active.shape[0]
    device = active.device
    s1, s2 = scene.slot_s1, scene.slot_s2
    both = scene.slot_enabled[s1] & scene.slot_enabled[s2] & active
    labels = torch.arange(ns, device=device)[None, :].expand(B, ns)

    # static slot-incidence matrix of the contact slots: inc[k, s] == slot k
    # touches pose slot s; propagation is one masked (K, ns) reduce-min per
    # sweep
    K = int(scene.n_contacts)
    inc = sc.cached(scene, ("island_inc", str(device)), lambda: _incidence(
        scene, K, ns, device))
    ab_ranges = []
    off = scene.nb
    for ent in scene.arts:
        ab_ranges.append((off, off + ent.model.nl))
        off += ent.model.nl
    # point joints couple two slots (only those: as in the reference package)
    bi_edges = [(b.slot_a, b.slot_b) for b in scene.bilaterals
                if b.btype == bil.POINT]
    for _ in range(ns):
        m = torch.minimum(labels[:, s1], labels[:, s2])
        upd = torch.where(both, m, ns)
        prop = torch.where(inc[None], upd[:, :, None], ns).amin(dim=1) if K \
            else torch.full_like(labels, ns)
        labels = torch.minimum(labels, prop)
        if ab_ranges:
            labels = torch.cat(
                [labels[:, :ab_ranges[0][0]]]
                + [labels[:, a:b].amin(dim=1, keepdim=True).expand(B, b - a)
                   for a, b in ab_ranges]
                + [labels[:, ab_ranges[-1][1]:]], dim=1)
        if bi_edges:
            labels = labels.clone()
            for sa, sb in bi_edges:
                mn = torch.minimum(labels[:, sa], labels[:, sb])
                labels[:, sa] = mn
                labels[:, sb] = mn
    return labels


def _incidence(scene, K, ns, device):
    inc = np.zeros((K, ns), bool)
    inc[np.arange(K), scene.host["slot_s1"]] = True
    inc[np.arange(K), scene.host["slot_s2"]] = True
    return torch.as_tensor(inc, device=device)


class Problem(NamedTuple):
    Jn: torch.Tensor   # (B, K, ngc)
    Js: torch.Tensor
    Jt: torch.Tensor
    Jl: torch.Tensor   # (B, NL, ngc) signed limit rows (empty: no limits yet)
    Minv: torch.Tensor  # (B, ngc, ngc)
    Ann: torch.Tensor
    Ans: torch.Tensor
    Ant: torch.Tensor
    Anl: torch.Tensor
    Ass: torch.Tensor
    Ast: torch.Tensor
    Asl: torch.Tensor
    Att: torch.Tensor
    Atl: torch.Tensor
    All: torch.Tensor
    Cn_v: torch.Tensor
    Cs_v: torch.Tensor
    Ct_v: torch.Tensor
    L_v: torch.Tensor
    # stacked forms (the hot-path representation; the named blocks above are
    # views into these)
    Jall: torch.Tensor = None  # (B, 3K+NL, ngc) rows [Jn; Js; Jt; Jl]
    A: torch.Tensor = None     # (B, 3K+NL, 3K+NL) Jall Minv Jall^T
    bv: torch.Tensor = None    # (B, 3K+NL) Jall v
    # free-body block-diagonal inverse inertia (B, n_live, 6, 6) and the
    # live-compressed contact rows (B, 3K+NL, n_live, 6): inv(M) products run
    # as per-body contractions over the live bodies only
    Minv_blk: torch.Tensor = None
    Jr_live: torch.Tensor = None


def _contact_rows(scene, pt: PoseTable, con: Contacts, act, d_vec):
    """(B, K, ngc) rows: [d, r×d]·W_s1 − [d, r×d]·W_s2
    (add_contact_dir_to_Jacobian, src/ImpactConstraintHandler.cpp:1857)."""
    s1, s2 = con.s1, con.s2
    dm = torch.where(act[..., None], d_vec, 0.0)
    r1 = con.point - pt.pos[:, s1]
    r2 = con.point - pt.pos[:, s2]
    w1 = torch.cat([dm, _cross(r1, dm)], dim=-1)  # (B, K, 6)
    w2 = torch.cat([dm, _cross(r2, dm)], dim=-1)
    return wrench_rows(pt.W, s1, w1) - wrench_rows(pt.W, s2, w2)


def _live_free_idx(scene: sc.Scene):
    live = scene.host["enabled"] & (scene.host["mass"] > 0)
    return np.nonzero(live)[0]


def free_inv_inertia_blocks_live(scene: sc.Scene, quat_b):
    """(B, n_live, 6, 6) inverse spatial inertia blocks of the statically-live
    free bodies, in world frame."""
    il = _live_free_idx(scene)
    R = quat.to_matrix(quat_b[:, il])
    Iinv_w = R @ scene.inv_inertia[il] @ R.transpose(-1, -2)
    B, nl = Iinv_w.shape[:2]
    blk = quat_b.new_zeros((B, nl, 6, 6))
    lin = scene.inv_mass[il]
    for a in range(3):
        blk[:, :, a, a] = lin
    blk[:, :, 3:, 3:] = Iinv_w
    return blk


def free_inv_inertia_blocks(scene: sc.Scene, quat_b):
    """(B, nb, 6, 6) per-free-body inverse spatial inertia blocks in world
    (zero rows for disabled/massless fixtures)."""
    nb = scene.nb
    il = _live_free_idx(scene)
    blk_l = free_inv_inertia_blocks_live(scene, quat_b)
    if len(il) == nb:
        return blk_l
    out = quat_b.new_zeros((quat_b.shape[0], nb, 6, 6))
    out[:, il] = blk_l
    return out


def gc_inv_inertia(scene: sc.Scene, st, quat_b):
    """Dense (B, ngc, ngc) inverse inertia: 6x6 free-body blocks and, per
    articulated body, its joint-space H(q)^{-1} on the diagonal (the
    reference's X, compute_X :1590).

    H is SPD: in float32 (the card's dtype) it is inverted by the unpivoted
    Gauss–Jordan `lcp.gj_invert_pd`, in float64 (the regression mode) by
    LAPACK, as the JAX package switches on the dtype."""
    nb, ngc = scene.nb, scene.ngc
    B = quat_b.shape[0]
    out = quat_b.new_zeros((B, ngc, ngc))
    if nb:
        blk = free_inv_inertia_blocks(scene, quat_b)
        for b in range(nb):
            out[:, 6 * b: 6 * b + 6, 6 * b: 6 * b + 6] = blk[:, b]
    for ent in scene.arts:
        m = ent.model
        H = art_dyn.crb(m, st.q_art[:, ent.q_off: ent.q_off + m.nq])
        if H.dtype == torch.float32:
            Hinv, _ = lcp.gj_invert_pd(H)
        else:
            Hinv = torch.linalg.inv(H)
        g = ent.gc_off
        out[:, g: g + m.nv, g: g + m.nv] = Hinv
    return out


def _lim_onehot(scene, dtype, device):
    """(NL, ngc): row i has a 1 at limit i's gc column."""
    oh = np.zeros((scene.n_limits, scene.ngc))
    oh[np.arange(scene.n_limits), scene.host["lim_gc_col"]] = 1.0
    return torch.as_tensor(oh, dtype=dtype, device=device)


def limit_activity_state(scene: sc.Scene, st, near_zero):
    """Active limit slots (q beyond the limit:
    ArticulatedBody::find_limit_constraints) and their constraint velocity
    (±qd: compute_limit_components / calc_constraint_vel), both (B, NL)."""
    B = st.pos.shape[0]
    if scene.n_limits == 0:
        return (torch.zeros((B, 0), dtype=torch.bool, device=st.pos.device),
                st.pos.new_zeros((B, 0)))
    q = st.q_art[:, scene.lim_q_idx]
    qd = st.qd_art[:, scene.lim_gc_col - 6 * scene.nb]
    act = torch.where(scene.lim_upper, q >= scene.lim_value, q <= scene.lim_value)
    vel = torch.where(scene.lim_upper, -qd, qd)
    return act, vel


def assemble_problem(scene, st, pt: PoseTable, con: Contacts, act, act_lim) -> Problem:
    """One stacked Jacobian Jall = [Jn; Js; Jt; Jl], ONE Delassus
    A = Jall Minv Jall^T and one bv = Jall v; the named blocks are slices.
    With bilateral constraints Minv is the projected X (compute_X, :1590)."""
    dtype = st.pos.dtype
    K = scene.n_contacts
    NL = scene.n_limits
    ngc = scene.ngc
    B = st.pos.shape[0]

    # contact rows for all 3 directions in one batch
    if K:
        s1 = torch.cat([con.s1] * 3)
        s2 = torch.cat([con.s2] * 3)
        D = torch.cat([con.normal, con.tan1, con.tan2], dim=1)
        act3 = torch.cat([act] * 3, dim=1)
        pts = torch.cat([con.point] * 3, dim=1)
        dm = torch.where(act3[..., None], D, 0.0)
        r1 = pts - pt.pos[:, s1]
        r2 = pts - pt.pos[:, s2]
        w1 = torch.cat([dm, _cross(r1, dm)], dim=-1)  # (B, 3K, 6)
        w2 = torch.cat([dm, _cross(r2, dm)], dim=-1)
        J3 = wrench_rows(pt.W, s1, w1) - wrench_rows(pt.W, s2, w2)
    else:
        J3 = st.pos.new_zeros((B, 0, ngc))

    if NL:
        sign = torch.where(scene.lim_upper, -1.0, 1.0).to(dtype)
        sign = torch.where(act_lim, sign, 0.0)
        onehot = sc.cached(scene, ("lim_onehot", str(dtype), str(st.pos.device)),
                           lambda: _lim_onehot(scene, dtype, st.pos.device))
        Jl = sign[..., None] * onehot                 # (B, NL, ngc)
    else:
        Jl = st.pos.new_zeros((B, 0, ngc))
    Jall = torch.cat([J3, Jl], dim=1)                 # (B, 3K+NL, ngc)

    Minv = gc_inv_inertia(scene, st, st.quat)
    if scene.bilaterals:
        Jb, _ = bil.constraint_rows(scene, st, pt)
        Minv = bil.project_inv_inertia(Minv, Jb)
    v = gc_velocity(scene, st)

    # free-body scenes: Delassus via per-body 6x6 blocks, restricted to the
    # statically-live bodies (Jall's columns for disabled fixtures are
    # identically zero). Gate on every ENABLED body being massive: an
    # enabled-but-massless (kinematic) body has zero Minv blocks but nonzero
    # velocity rows in bv = Jall @ v, which the live compression would drop.
    Minv_blk = None
    Jr_live = None
    all_enabled_massive = bool(
        ((scene.host["mass"] > 0) | ~scene.host["enabled"]).all())
    if (not scene.arts and not scene.bilaterals and scene.nb and K
            and all_enabled_massive):
        assert scene.n_pose_slots == scene.nb
        il = _live_free_idx(scene)
        Minv_blk = free_inv_inertia_blocks_live(scene, st.quat)
        il_t = sc.cached(scene, ("live_idx", str(st.pos.device)),
                         lambda: torch.as_tensor(il, device=st.pos.device))
        m1 = (s1[:, None] == il_t[None, :]).to(dtype)
        m2 = (s2[:, None] == il_t[None, :]).to(dtype)
        Jr_live = (m1[None, :, :, None] * w1[:, :, None, :]
                   - m2[None, :, :, None] * w2[:, :, None, :])  # (B,3K,nl,6)
        A = torch.einsum("banp,bnpq,bcnq->bac", Jr_live, Minv_blk, Jr_live)
        bv = torch.einsum("banp,bnp->ba", Jr_live,
                          v.reshape(B, scene.nb, 6)[:, il])
    else:
        A = (Jall @ Minv) @ Jall.transpose(-1, -2)
        bv = (Jall @ v[..., None])[..., 0]

    return Problem(
        Minv_blk=Minv_blk, Jr_live=Jr_live,
        Jn=Jall[:, :K], Js=Jall[:, K: 2 * K], Jt=Jall[:, 2 * K: 3 * K],
        Jl=Jall[:, 3 * K:], Minv=Minv,
        Ann=A[:, :K, :K], Ans=A[:, :K, K: 2 * K], Ant=A[:, :K, 2 * K: 3 * K],
        Anl=A[:, :K, 3 * K:],
        Ass=A[:, K: 2 * K, K: 2 * K], Ast=A[:, K: 2 * K, 2 * K: 3 * K],
        Asl=A[:, K: 2 * K, 3 * K:],
        Att=A[:, 2 * K: 3 * K, 2 * K: 3 * K], Atl=A[:, 2 * K: 3 * K, 3 * K:],
        All=A[:, 3 * K:, 3 * K:],
        Cn_v=bv[:, :K],
        Cs_v=bv[:, K: 2 * K],
        Ct_v=bv[:, 2 * K: 3 * K],
        L_v=bv[:, 3 * K:],
        Jall=Jall, A=A, bv=bv,
    )


@lru_cache(maxsize=64)
def _qp_tables_cached(key):
    (K, NL, NF, fr, fr_cos, fr_sin, mu_c, mu_v, compliance, dtname) = key
    fr = np.array(fr, np.int64)
    fr_cos = np.array(fr_cos)
    fr_sin = np.array(fr_sin)
    mu_c = np.array(mu_c)
    mu_v = np.array(mu_v)
    compliance = np.array(compliance)
    dt = np.dtype(dtname)
    NV = 5 * K + NL
    NI = K + NL + NF
    n = NV + NI

    # variable -> (row of A, sign): x = [cn, cs, ct, ncs, nct, l]
    vm = np.concatenate([
        np.arange(K), K + np.arange(K), 2 * K + np.arange(K),
        K + np.arange(K), 2 * K + np.arange(K), 3 * K + np.arange(NL),
    ]).astype(np.int64)
    vs = np.concatenate([
        np.ones(K), np.ones(K), np.ones(K),
        -np.ones(K), -np.ones(K), np.ones(NL),
    ])
    # inequality row -> (row of A, sign); friction rows have no A part
    im = np.concatenate([
        np.arange(K), 3 * K + np.arange(NL), np.zeros(NF, np.int64)])
    is_ = np.concatenate([np.ones(K), np.ones(NL), np.zeros(NF)])
    # constant friction-cone rows (slot_mu_c / fan cos/sin are scene statics)
    Mf = np.zeros((NI, NV))
    r0 = K + NL
    for j in range(NF):
        Mf[r0 + j, fr[j]] = mu_c[fr[j]]
        Mf[r0 + j, K + fr[j]] = -fr_cos[j]
        Mf[r0 + j, 3 * K + fr[j]] = -fr_cos[j]
        Mf[r0 + j, 2 * K + fr[j]] = -fr_sin[j]
        Mf[r0 + j, 4 * K + fr[j]] = -fr_sin[j]

    rm = np.concatenate([vm, im])        # (n,) A-row per MM row
    rs = np.concatenate([vs, is_])
    cm = np.concatenate([vm, im])        # (n,) A-col per MM col
    cs_sign = np.concatenate([vs, -is_])  # upper-right block is -Mineq^T

    I = np.broadcast_to(rm[:, None], (n, n)).copy()
    J = np.broadcast_to(cm[None, :], (n, n)).copy()
    S = rs[:, None] * cs_sign[None, :]
    # zero the (ineq, ineq) block; the lower-left block is already +Mineq
    S[NV:, NV:] = 0.0
    C = np.zeros((n, n))
    C[np.arange(K), np.arange(K)] += compliance        # H compliance diag
    C[NV:, :NV] += Mf                                  # +Mineq friction
    C[:NV, NV:] += -Mf.T                               # -Mineq^T

    # qq = qs * bv[qm] + qt * tvel[qf]
    qm = np.concatenate([vm, im]).astype(np.int64)
    qs = np.concatenate([vs, is_])
    qf = np.zeros(n, np.int64)
    qt = np.zeros(n)
    qf[NV + r0: NV + r0 + NF] = fr
    qt[NV + r0: NV + r0 + NF] = mu_v[fr]

    return (
        np.ascontiguousarray(I), np.ascontiguousarray(J),
        S.astype(dt), C.astype(dt),
        qm, qs.astype(dt), qf, qt.astype(dt),
    )


def _qp_tables(scene: sc.Scene, dtype, device):
    """Index/sign/constant tables of the KKT stack, as tensors on `device`
    (built once per scene, dtype and device)."""
    def make():
        h = scene.host
        key = (
            scene.n_contacts, scene.n_limits, scene.n_friction_rows,
            tuple(h["fr_con"].tolist()), tuple(h["fr_cos"].tolist()),
            tuple(h["fr_sin"].tolist()), tuple(h["slot_mu_c"].tolist()),
            tuple(h["slot_mu_v"].tolist()),
            tuple(h["slot_compliance"].tolist()),
            np.dtype(cfg.numpy_dtype(dtype)).name,
        )
        return tuple(torch.as_tensor(t, device=device)
                     for t in _qp_tables_cached(key))
    return sc.cached(scene, ("qp_tables", str(dtype), str(device)), make)


def build_qp_lcp(scene: sc.Scene, p: Problem, act, act_lim):
    """Stack the QP into the monolithic KKT LCP (setup_QP + solve_qp_work).

    Variables x = [cn, cs, ct, ncs, nct, l]; inequality rows
    [Cn·v+ >= 0 (K)], [L·v+ >= 0 (NL)], [friction (NF)].
    MM = [[H, -M'], [M, 0]],  qq = [c, Cn_v, L_v, mu_visc·|v_t|].

    Every MM entry is (± an entry of the stacked Delassus A) + a static
    constant, so the whole stack is ONE gather + multiply-add against static
    index/sign/const tables (`_qp_tables`).
    """
    dtype = p.Ann.dtype
    I, J, S, C, qm, qs, qf, qt = _qp_tables(scene, dtype, p.A.device)

    bv = torch.cat([p.Cn_v, p.Cs_v, p.Ct_v, p.L_v], dim=1)
    MM = S * p.A[:, I, J] + C
    qq = qs * bv[:, qm]
    # viscous term mu_v*|v_t|: statically skipped when every mu_v is zero;
    # with nonzero mu_v the sqrt argument is floored at tiny, so the |v_t|
    # subgradient at 0 is 0
    if scene.n_friction_rows and float(np.max(scene.host["slot_mu_v"])) != 0.0:
        tiny = torch.finfo(dtype).tiny
        tvel = torch.sqrt((p.Cs_v ** 2 + p.Ct_v ** 2).clamp_min(tiny))
        qq = qq + qt * tvel[:, qf]

    fr = scene.fr_con
    var_act = torch.cat([act] * 5 + [act_lim], dim=1)
    row_act = torch.cat([act, act_lim, act[:, fr]], dim=1)
    mask = torch.cat([var_act, row_act], dim=1)
    return MM, qq, mask


def unstack_impulses(scene: sc.Scene, z):
    K = scene.n_contacts
    cn = z[:, :K]
    cs = z[:, K: 2 * K] - z[:, 3 * K: 4 * K]
    ct = z[:, 2 * K: 3 * K] - z[:, 4 * K: 5 * K]
    l = z[:, 5 * K: 5 * K + scene.n_limits]
    return cn, cs, ct, l


def _impulse_vec(scene: sc.Scene, z):
    """z (B, n_lcp) -> stacked impulse (B, 3K+NL) = [cn, cs-ncs, ct-nct, l]."""
    cn, cs, ct, l = unstack_impulses(scene, z)
    return torch.cat([cn, cs, ct, l], dim=1)


def impulse_dv(scene, p: Problem, cn, cs, ct, l):
    """dv = inv(M)(Jn'cn + Js'cs + Jt'ct + Jl'l) (update_from_stacked)."""
    def jt(J, x):
        return (J.transpose(-1, -2) @ x[..., None])[..., 0]
    w = jt(p.Jn, cn) + jt(p.Js, cs) + jt(p.Jt, ct) + jt(p.Jl, l)
    return (p.Minv @ w[..., None])[..., 0]


def _min_constraint_vel(Cn_v, act, L_v, act_lim):
    inf = Cn_v.new_full((Cn_v.shape[0], 1), torch.inf)
    vals = torch.cat(
        [
            torch.where(act, Cn_v, torch.inf),
            torch.where(act_lim, L_v, torch.inf),
            inf,
        ],
        dim=1,
    )
    return vals.amin(dim=1)


def group_labels(scene, con):
    """Island label of every contact slot (B, K) and limit slot (B, NL) (the
    connected constraint groups of `determine_connected_constraints`)."""
    labels = island_labels(scene, con.active)
    ns = scene.n_pose_slots
    s1, s2 = scene.slot_s1, scene.slot_s2
    lab1 = torch.where(scene.slot_enabled[s1], labels[:, s1], ns)
    lab2 = torch.where(scene.slot_enabled[s2], labels[:, s2], ns)
    con_lab = torch.minimum(lab1, lab2)
    if scene.n_limits:
        def make():
            col_to_slot = np.zeros(scene.ngc, np.int64)
            off = scene.nb
            for ent in scene.arts:
                col_to_slot[ent.gc_off: ent.gc_off + ent.model.nv] = off
                off += ent.model.nl
            return torch.as_tensor(col_to_slot[scene.host["lim_gc_col"]],
                                   device=labels.device)
        lim_lab = labels[:, sc.cached(scene, ("lim_slot", str(labels.device)), make)]
    else:
        lim_lab = labels.new_zeros((labels.shape[0], 0))
    return con_lab, lim_lab


def _any_in_group(lab_q, lab_src, flags):
    """(B, Q): some `flags` member (B, S) shares the label of each query
    (`lab_src` (B, S), `lab_q` (B, Q)) — a per-scenario scatter-max over the
    labels written as one (B, Q, S) comparison."""
    return ((lab_q[:, :, None] == lab_src[:, None, :])
            & flags[:, None, :]).any(dim=2)


def model_masks(scene, con):
    """Per-island impact-model routing (`apply_model`'s per-group dispatch,
    src/ImpactConstraintHandler.cpp:113-151): a group where every active
    contact has mu >= 100 uses the no-slip MLCP; else a group with any
    true-cone contact (NK = inf) uses the NQP; else the QP. Returns
    ((act_ns, lim_ns), (act_nqp, lim_nqp), (act_qp, lim_qp)) slot filters,
    each (B, K) or (B, NL)."""
    con_lab, lim_lab = group_labels(scene, con)
    finite = con.active & ~(scene.slot_mu_c >= 1e2)
    tc = con.active & scene.slot_truecone

    con_ns = ~_any_in_group(con_lab, con_lab, finite)
    con_nqp = _any_in_group(con_lab, con_lab, tc) & ~con_ns
    lim_ns = ~_any_in_group(lim_lab, con_lab, finite)
    lim_nqp = _any_in_group(lim_lab, con_lab, tc) & ~lim_ns
    return ((con_ns, lim_ns), (con_nqp, lim_nqp),
            (~con_ns & ~con_nqp, ~lim_ns & ~lim_nqp))


def _active(scene, st, pt, con, nz):
    """Solve masks (contacts, limits) plus raw constraint velocities."""
    cn_vel, _, _ = contact_velocities(scene, pt, con)
    lim_act, lim_vel = limit_activity_state(scene, st, nz)
    con_lab, lim_lab = group_labels(scene, con)

    # "group has an impacting member" via label comparison: O(K^2) bools
    neg_con = con.active & (cn_vel < -nz)
    neg_lim = lim_act & (lim_vel < -nz)
    act = con.active & (_any_in_group(con_lab, con_lab, neg_con)
                        | _any_in_group(con_lab, lim_lab, neg_lim))
    act_lim = lim_act & (_any_in_group(lim_lab, con_lab, neg_con)
                         | _any_in_group(lim_lab, lim_lab, neg_lim))
    return act, act_lim, cn_vel, lim_vel


def resolve_impacts(
    scene: sc.Scene, st, pt: PoseTable, con: Contacts, zlast, zlast_active,
    lcp_solver=None, act_filter=None, lim_filter=None, cascade=None,
) -> ImpactResult:
    """Full impact pipeline for one step (QP model). Returns the gc velocity
    delta (zero when no constraint is impacting —
    `calc_impacting_unilateral_constraint_forces` early-out).

    `lcp_solver(M, q, mask, z0, skip=) -> (z, ok[, stats])` defaults to the
    production pivoting cascade (`cascade` is handed to it).
    `act_filter`/`lim_filter` restrict the solve to a subset of contact and
    limit slots.
    """
    if lcp_solver is None:
        def lcp_solver(M, q, m, z0, skip=None):
            return lcp.solve_lcp(M, q, m, z0=z0, skip=skip, with_stats=True,
                                 cascade=cascade, device=M.device)

    def call_solver(M, q, m, z0_, skip_):
        """Normalize (z, ok) / (z, ok, stats) solver returns."""
        out = lcp_solver(M, q, m, z0_, skip=skip_)
        if len(out) == 3:
            return out
        z_, ok_ = out
        B_ = q.shape[0]
        return z_, ok_, lcp.LCPStats(
            pivots=torch.zeros(B_, dtype=torch.int32, device=q.device),
            fallback=torch.zeros(B_, dtype=torch.bool, device=q.device),
        )

    dtype = st.pos.dtype
    nz = cfg.near_zero(dtype)
    K = scene.n_contacts

    act, act_lim, cn_vel, lim_vel = _active(scene, st, pt, con, nz)
    if act_filter is not None:
        act = act & act_filter
    if lim_filter is not None and scene.n_limits:
        act_lim = act_lim & lim_filter
    any_impact = act.any(dim=1) | act_lim.any(dim=1)

    p = assemble_problem(scene, st, pt, con, act, act_lim)
    MM, qq, mask = build_qp_lcp(scene, p, act, act_lim)

    same = (zlast_active == act).all(dim=1) & zlast_active.any(dim=1)
    z0 = torch.where(same[:, None], zlast, 0.0)

    # nothing impacting -> dv is zeroed below anyway; skip the pivot loops
    z, ok, st1 = call_solver(MM, qq, mask, z0, ~any_impact)
    cn1 = z[:, :K]
    imp1 = _impulse_vec(scene, z)
    # post-solve constraint velocities via the Delassus operator
    bv1 = p.bv + (p.A @ imp1[..., None])[..., 0]
    Cn_v1 = bv1[:, :K]
    L_v1 = bv1[:, 3 * K:]
    minv = _min_constraint_vel(Cn_v1, act, L_v1, act_lim)

    # Poisson restitution: scale the cn segment of the stacked z
    # (apply_restitution(q, z), src/ImpactConstraintHandler.cpp:470-500).
    # When every restitution coefficient is zero (static) the scaled impulses
    # vanish and dv == dv1: skip the whole second assembly + gated solve.
    eps_all_zero = (
        (K == 0 or float(np.max(scene.host["slot_eps"])) == 0.0)
        and (scene.n_limits == 0
             or float(np.max(scene.host["lim_eps"])) == 0.0))

    def _impulse_to_dv(imp):
        """dv = inv(M) Jallᵀ imp, through the live-compressed blocks when
        the scene provides them."""
        if p.Jr_live is not None:
            il = _live_free_idx(scene)
            w_l = torch.einsum("banp,ba->bnp", p.Jr_live, imp)
            dv_l = torch.einsum("bnpq,bnq->bnp", p.Minv_blk, w_l)
            B_ = imp.shape[0]
            if len(il) == scene.nb:
                return dv_l.reshape(B_, -1)
            out = imp.new_zeros((B_, scene.nb, 6))
            out[:, il] = dv_l
            return out.reshape(B_, -1)
        w = (p.Jall.transpose(-1, -2) @ imp[..., None])
        return (p.Minv @ w)[..., 0]

    def _bilateral_fix(dv):
        """Add the λ-correction removing the bilateral constraint-velocity
        violation (update_from_stacked, :355-379) — whether or not a
        unilateral impact fired: a violating velocity must not persist
        until an unrelated impact fires."""
        if not scene.bilaterals:
            return dv
        Jb, _ = bil.constraint_rows(scene, st, pt)
        Minv_raw = gc_inv_inertia(scene, st, st.quat)
        v_pre = gc_velocity(scene, st)
        return dv + bil.velocity_correction(Minv_raw, Jb, v_pre + dv)

    ai = any_impact[:, None]
    if eps_all_zero:
        dv = _impulse_to_dv(imp1)
        z_f = z
        dv = _bilateral_fix(torch.where(ai, dv, 0.0))
        z_out = torch.where(ai, z_f, zlast)
        za_out = torch.where(ai, act, zlast_active)
        cn_total = torch.where(ai, cn1, 0.0)
        pivots = st1.pivots.to(torch.int32)
        fallbacks = st1.fallback.to(torch.int32)
        return ImpactResult(
            dv, z_out, za_out, cn_total, pivots, fallbacks,
            z_step=torch.where(ai, z_f, 0.0),
        )

    NL = scene.n_limits
    zr = z.clone()
    zr[:, :K] *= scene.slot_eps
    zr[:, 5 * K: 5 * K + NL] *= scene.lim_eps
    changed = (zr[:, :K] > nz).any(dim=1) | (zr[:, 5 * K: 5 * K + NL] > nz).any(dim=1)

    cn2 = zr[:, :K]
    imp2 = _impulse_vec(scene, zr)
    bv2 = bv1 + (p.A @ imp2[..., None])[..., 0]
    Cn_v2 = bv2[:, :K]
    L_v2 = bv2[:, 3 * K:]
    minv_plus = _min_constraint_vel(Cn_v2, act, L_v2, act_lim)

    need_resolve = changed & (minv_plus < 0.0) & (minv_plus < minv - nz)

    # second impact problem from post-restitution velocities
    p2 = p._replace(
        Cn_v=Cn_v2,
        Cs_v=bv2[:, K: 2 * K],
        Ct_v=bv2[:, 2 * K: 3 * K],
        L_v=L_v2,
    )
    MM2, qq2, _ = build_qp_lcp(scene, p2, act, act_lim)
    # the second impact solve only matters when restitution re-triggers
    # impacts — those that do not are done at entry
    z3, _, st3 = call_solver(MM2, qq2, mask, z, ~need_resolve)
    cn3 = z3[:, :K]
    imp3 = _impulse_vec(scene, z3)

    ch = changed[:, None]
    nr = need_resolve[:, None]
    imp_tot = imp1 + torch.where(ch, imp2, 0.0) + torch.where(nr, imp3, 0.0)
    dv = _impulse_to_dv(imp_tot)
    z_f = torch.where(nr, z3, z)

    dv = _bilateral_fix(torch.where(ai, dv, 0.0))
    z_out = torch.where(ai, z_f, zlast)
    za_out = torch.where(ai, act, zlast_active)
    cn_total = torch.where(
        ai,
        cn1 + torch.where(ch, cn2, 0.0) + torch.where(nr, cn3, 0.0),
        0.0,
    )
    pivots = (st1.pivots + st3.pivots).to(torch.int32)
    fallbacks = st1.fallback.to(torch.int32) + st3.fallback.to(torch.int32)
    return ImpactResult(
        dv, z_out, za_out, cn_total, pivots, fallbacks,
        z_step=torch.where(ai, z_f, 0.0),
    )
