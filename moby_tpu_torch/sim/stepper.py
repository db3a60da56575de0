"""The time-stepping simulator core (counterpart of
``moby_tpu/sim/stepper.py``: free and articulated bodies, joint limits,
bilateral constraints, compliant (penalty) contact, and the QP, no-slip and
true-cone (NQP) impact models, routed per island when a scene mixes them).

Mirror of the reference's live stepper (`TimeSteppingSimulator::step` ->
`step_si_Euler` -> `do_mini_step`, src/TimeSteppingSimulator.cpp:52-222):

  step(dt):
    while h < dt:  do_mini_step(dt-h)
    constraint stabilization                    [see stabilization.py]

  do_mini_step(Δ):
    save q
    while h < Δ:
      CA = conservative advancement bound       (CCD::calc_CA_Euler_step +
      if CA <= 0: break                          joint-limit ETAs,
      tc = min(Δ-h, max(min_step_size, CA))      TimeSteppingSimulator:272-331)
      q  = qsave + qd_euler·(h+tc)              (position from saved coords,
      h += tc                                    Euler velocity at qsave)
    a = fwd_dyn(q, v)                           (free bodies: Newton-Euler;
                                                 articulated: Featherstone ABA)
    + penalty forces of compliant contacts,
      bilateral acceleration-level KKT
    v += a·h ;  dissipation
    find contacts at q;  impact handler         [per-island model routing]

Every array carries the batch of scenarios as its leading dimension. The two
while loops have data-dependent trip counts per scenario, exactly like the
reference (safety-capped): each is a Python loop of masked batched
iterations, `torch.where(active, new, old)` per field, that ends when no
scenario is active (one host synchronisation per iteration) or at its cap.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as cfg
from ..core import scene as sc
from ..dynamics import aba as art_dyn
from ..dynamics import model as amdl
from ..geometry import narrowphase as nph
from ..math import quaternion as quat
from ..solvers.lcp import _check_device
from . import bilateral
from . import impact
from . import kinematics
from . import noslip
from . import nqp
from . import stabilization

MAX_MINI_STEPS = 64
MAX_CA_ITERS = 32


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def forward_dynamics_free(scene: sc.Scene, quat_b, omega, vel=None):
    """Free-body accelerations: gravity + gyroscopic moment + drag forces
    (Ravelin RigidBodyd::calc_fwd_dyn + StokesDragForce/DampingForce).

    The rotation/inertia chain runs only over the statically-live bodies
    (enabled & massive): disabled fixtures' rows are exact zeros."""
    live_np = scene.host["enabled"] & (scene.host["mass"] > 0)
    live = scene.enabled & (scene.mass > 0)
    a_lin = torch.where(live[:, None], scene.gravity[None, :], 0.0)
    a_lin = a_lin.expand(omega.shape).clone()
    if vel is not None:
        # F = -b v (src/StokesDragForce.cpp:33-62)
        a_lin = a_lin - scene.inv_mass[:, None] * scene.drag_lin[:, None] * vel
    il = np.nonzero(live_np)[0]
    nb = scene.nb
    if len(il) == 0:
        return a_lin, torch.zeros_like(omega)
    gather = len(il) < nb
    q_l = quat_b[:, il] if gather else quat_b
    w_l = omega[:, il] if gather else omega
    R = quat.to_matrix(q_l)
    Rt = R.transpose(-1, -2)
    Iw = R @ scene.inertia[il] @ Rt
    Iw_inv = R @ scene.inv_inertia[il] @ Rt
    gyro = -_cross(w_l, (Iw @ w_l[..., None])[..., 0])
    if vel is not None:
        # τ = -b_ang ω
        gyro = gyro - scene.drag_ang[il, None] * w_l
    a_ang_l = (Iw_inv @ gyro[..., None])[..., 0]
    if not gather:
        return a_lin, torch.where(live[:, None], a_ang_l, 0.0)
    a_ang = torch.zeros_like(omega)
    a_ang[:, il] = a_ang_l
    return a_lin, a_ang


def penalty_forces(scene: sc.Scene, pt, con):
    """Compliant (penalty) contact forces: spring-damper on the deepest
    compliant contact per pair (PenaltyConstraintHandler.cpp:79-205).
    Returns a gc force vector (B, ngc)."""
    B = pt.pos.shape[0]
    compl = scene.slot_compliant & (con.depth < 0.0)
    # deepest per pair: a per-scenario scatter-min over the pairs
    pair = con.pair.expand(B, -1)
    pair_min = pt.pos.new_full((B, scene.n_pairs), torch.inf).scatter_reduce(
        1, pair, torch.where(compl, con.depth, torch.inf), "amin")
    deepest = compl & (con.depth <= pair_min.gather(1, pair))

    cnv, csv, ctv = impact.contact_velocities(scene, pt, con)
    fN = (-con.depth * scene.slot_kp - cnv * scene.slot_kv).clamp_min(0.0)
    fN = torch.where(deepest, fN, 0.0)
    # viscous sliding friction
    fs = -torch.sign(csv) * fN * scene.slot_mu_v
    ft = -torch.sign(ctv) * fN * scene.slot_mu_v
    # force on body1 along +n (+tangential), reaction on body2
    fvec = (fN[..., None] * con.normal + fs[..., None] * con.tan1
            + ft[..., None] * con.tan2)
    r1 = con.point - pt.pos[:, con.s1]
    r2 = con.point - pt.pos[:, con.s2]
    w1 = torch.cat([fvec, _cross(r1, fvec)], dim=-1)
    w2 = torch.cat([fvec, _cross(r2, fvec)], dim=-1)
    return (kinematics.wrench_rows(pt.W, con.s1, w1).sum(dim=1)
            - kinematics.wrench_rows(pt.W, con.s2, w2).sum(dim=1))


def articulated_qdd(scene: sc.Scene, st: sc.State, tau=None):
    """Joint accelerations (B, nv_art) of every articulated body
    (`fdyn-algorithm fsab`); tau (B, nv_art) or None."""
    B = st.pos.shape[0]
    parts = []
    for ent in scene.arts:
        m = ent.model
        q = st.q_art[:, ent.q_off: ent.q_off + m.nq]
        qd = st.qd_art[:, ent.v_off: ent.v_off + m.nv]
        t = (tau[:, ent.v_off: ent.v_off + m.nv] if tau is not None
             else torch.zeros_like(qd))
        parts.append(art_dyn.aba(m, q, qd, t, scene.gravity))
    if not parts:
        return st.pos.new_zeros((B, 0))
    return torch.cat(parts, dim=-1)


def integrate_art_q(scene: sc.Scene, q_art, qd_art, h):
    """Euler-coordinate position integration per joint type (the
    reference's eEuler coordinates: quaternion joints integrate through the
    quaternion derivative). h is a scalar or (B,)."""
    if scene.nq_art == 0:
        return q_art
    h = torch.as_tensor(h, dtype=q_art.dtype, device=q_art.device)
    if h.dim() == 1:
        h = h[:, None]
    segs = []
    for ent in scene.arts:
        m = ent.model
        for i in range(m.nl):
            t = m.jtype[i]
            qo = ent.q_off + m.q_off[i]
            vo = ent.v_off + m.v_off[i]
            if t in (amdl.REVOLUTE, amdl.PRISMATIC, amdl.UNIVERSAL, amdl.PLANAR):
                n = amdl.NQ[t]
                segs.append(q_art[:, qo: qo + n] + qd_art[:, vo: vo + n] * h)
            elif t == amdl.SPHERICAL:
                qq = q_art[:, qo: qo + 4]
                w = qd_art[:, vo: vo + 3]
                segs.append(quat.normalize(qq + quat.deriv(qq, w) * h))
            elif t == amdl.FLOATING:
                pos = q_art[:, qo: qo + 3]
                qq = q_art[:, qo + 3: qo + 7]
                # floating joint qd: [ω_base; v_base] in base coords -> world
                Rb = quat.to_matrix(qq)
                w_w = (Rb @ qd_art[:, vo: vo + 3, None])[..., 0]
                v_w = (Rb @ qd_art[:, vo + 3: vo + 6, None])[..., 0]
                segs.append(pos + v_w * h)
                segs.append(quat.normalize(qq + quat.deriv(qq, w_w) * h))
    return torch.cat(segs, dim=-1)


def _slot_dir_speed(scene, pt, n, s):
    """Max surface speed of pose slot s along direction n:
    n·v + ||ω × n||·rmax (CCD::calc_max_dist, src/CCD.cpp:585-607)."""
    sp = torch.sum(n * pt.vel[:, s], dim=-1) + torch.linalg.vector_norm(
        _cross(pt.omega[:, s], n), dim=-1
    ) * scene.slot_rmax[s]
    return torch.where(scene.slot_enabled[s], sp, 0.0)


def _slot_pair_onehot(scene, device):
    """(K, NP) bool: contact slot k belongs to pair p (static)."""
    def make():
        P = np.zeros((scene.n_contacts, scene.n_pairs), bool)
        P[np.arange(scene.n_contacts), scene.host["slot_pair"]] = True
        return torch.as_tensor(P, device=device)
    return sc.cached(scene, ("slot_pair_onehot", str(device)), make)


def _pair_compliant(scene, device):
    """(NP,) bool: the pair owns a compliant contact slot (static)."""
    def make():
        out = np.zeros(scene.n_pairs, bool)
        np.logical_or.at(out, scene.host["slot_pair"], scene.host["slot_compliant"])
        return torch.as_tensor(out, device=device)
    return sc.cached(scene, ("pair_compliant", str(device)), make)


def ca_euler_step(scene: sc.Scene, st, pt, min_dist_obs):
    """Conservative-advancement bound over all pairs
    (calc_next_CA_Euler_step, TimeSteppingSimulator.cpp:272-331;
    CCD::calc_CA_Euler_step, src/CCD.cpp:122-236). Returns ((B,), (B, NP))."""
    dtype = pt.pos.dtype
    nz = cfg.near_zero(dtype)
    INF = torch.inf
    B = pt.pos.shape[0]

    if scene.n_pairs == 0:
        return _limit_eta(scene, st, pt.pos.new_full((B,), INF)), min_dist_obs

    # touch band: constraint stabilization parks separated bodies at
    # dist = 2·NEAR_ZERO, which sits just above the reference's
    # `dist > NEAR_ZERO -> generic CA` gate (CCD.cpp:147) — a rolling sphere
    # parked there would make the mini-step loop grind. The resting shortcuts
    # below treat the parking band as touching instead.
    touch_band = 4.0 * nz
    pd, con = nph.narrow_phase(scene, pt.pos, pt.quat, touch_band)
    dist = pd.dist

    mdo = torch.where(dist >= 0.0, 0.0, torch.minimum(min_dist_obs, dist))

    g1s = scene.geom_slot[scene.pair_g1]
    g2s = scene.geom_slot[scene.pair_g2]

    d0 = pd.pa - pd.pb
    d0n = torch.linalg.vector_norm(d0, dim=-1)
    n0 = d0 / d0n.clamp_min(1e-30)[..., None]
    dist_eff = torch.where(dist < 0.0, nz + (dist - mdo), dist)
    spA = _slot_dir_speed(scene, pt, -n0, g1s)
    spB = _slot_dir_speed(scene, pt, n0, g2s)
    total = (spA + spB).clamp_min(0.0)
    step_generic = torch.where(total > 0.0, dist_eff / total, INF)

    cnv, _, _ = impact.contact_velocities(scene, pt, con)
    slot_touch = con.active
    P = _slot_pair_onehot(scene, dist.device)[None]        # (1, K, NP)
    approaching = ((slot_touch & (cnv < -nz))[:, :, None] & P).any(dim=1)
    ncon = (slot_touch[:, :, None] & P).sum(dim=1)
    max_abs_cvel = torch.where(
        P, torch.where(slot_touch, cnv.abs(), 0.0)[:, :, None], 0.0
    ).amax(dim=1)

    kind = scene.pair_kind
    is_sphereish = (
        (kind == sc.K_SPHERE_SPHERE)
        | (kind == sc.K_SPHERE_PLANE)
        | (kind == sc.K_BOX_SPHERE)
    )
    sphere_rest = (
        is_sphereish
        & (dist <= touch_band)
        & (ncon == 1)
        & (max_abs_cvel < nz * 10)
    )
    face_rest = (
        (~is_sphereish) & (dist <= touch_band) & (ncon >= 3) & ~approaching
    )

    step_pair = step_generic
    step_pair = torch.where((dist <= 0.0) & approaching, 0.0, step_pair)
    step_pair = torch.where(sphere_rest | face_rest, INF, step_pair)
    # touching non-sphere pair with < 3 contacts (edge/vertex support, e.g. a
    # box tipping on an edge): the generic estimator, bounded by the
    # vertex-sweep bound for plane-vs-polyhedron pairs
    vsweep = nph.plane_generic_sweep_bound(scene, pt, nz)
    step_pair = torch.where(
        (~is_sphereish) & (dist <= 0.0) & ~approaching & (ncon < 3),
        torch.where(step_pair <= 0.0, vsweep, torch.minimum(step_pair, vsweep)),
        step_pair,
    )
    sphere_touch_rec = is_sphereish & (dist <= 0.0) & ~sphere_rest & ~approaching
    step_pair = torch.where(sphere_touch_rec, INF, step_pair)

    # compliant pairs are not CA-limited (reference skips eCompliant bodies
    # in calc_next_CA_Euler_step, TimeSteppingSimulator.cpp:313-320)
    if scene.has_compliant:
        step_pair = torch.where(_pair_compliant(scene, dist.device), INF, step_pair)

    min_step = step_pair.amin(dim=1)
    return _limit_eta(scene, st, min_step), mdo


def _limit_eta(scene, st, min_step):
    """Joint-limit ETAs (TimeSteppingSimulator::calc_next_CA_Euler_step:280-307);
    min_step (B,)."""
    if scene.n_limits == 0:
        return min_step
    q = st.q_art[:, scene.lim_q_idx]
    qd = st.qd_art[:, scene.lim_gc_col - 6 * scene.nb]
    up = scene.lim_upper
    gap = (scene.lim_value - q) / torch.where(qd != 0, qd, 1.0)
    t_up = torch.where(up & (q < scene.lim_value) & (qd > 0.0), gap, torch.inf)
    t_lo = torch.where(~up & (q > scene.lim_value) & (qd < 0.0), gap, torch.inf)
    return torch.minimum(min_step, torch.minimum(t_up, t_lo).amin(dim=1))


def _refuse_unported(scene):
    if scene.legacy_velocity_first:
        raise NotImplementedError(
            "the legacy velocity-first step (step_legacy_vf) is not ported yet")


def do_mini_step(scene: sc.Scene, st: sc.State, dt_rem, controller=None,
                 tc_floor=None, cascade=None):
    """One `do_mini_step` (src/TimeSteppingSimulator.cpp:114-222) of every
    scenario; dt_rem is (B,). Returns (state, h (B,)).

    `tc_floor` raises the reference's `min_step_size` floor
    (TimeSteppingSimulator.cpp:149, `tc = max(min_step_size, CA_step)`) so a
    crawling conservative-advancement bound cannot stall the fixed iteration
    budget: the default NEAR_ZERO floor lets a settling contact pin CA at
    ~1e-8 s, where the capped loops would silently drop simulated time. The
    floor only engages when CA < tc_floor.
    """
    _refuse_unported(scene)
    pos0, quat0, qart0 = st.pos, st.quat, st.q_art
    B = pos0.shape[0]

    qdot = quat.deriv(quat0, st.omega)
    floor = scene.min_step_size
    if tc_floor is not None:
        floor = torch.maximum(floor, tc_floor)

    pos, qt, qa = pos0, quat0, qart0
    h = pos0.new_zeros(B)
    brk = torch.zeros(B, dtype=torch.bool, device=pos0.device)
    mdo = st.min_dist_obs
    for _ in range(MAX_CA_ITERS):
        active = ~brk & (h < dt_rem)
        if not bool(active.any()):
            break
        st_c = st.replace(pos=pos, quat=qt, q_art=qa)
        pt = kinematics.compute(scene, st_c)
        ca, mdo_n = ca_euler_step(scene, st_c, pt, mdo)
        brk_n = ca <= 0.0
        tc = torch.minimum(dt_rem - h, torch.maximum(floor, ca))
        hn = (h + tc)[:, None, None]
        newpos = pos0 + st.vel * hn
        newquat = quat.normalize(quat0 + qdot * hn)
        newq = integrate_art_q(scene, qart0, st.qd_art, h + tc)
        adv = (active & ~brk_n)
        pos = torch.where(adv[:, None, None], newpos, pos)
        qt = torch.where(adv[:, None, None], newquat, qt)
        qa = torch.where(adv[:, None], newq, qa)
        h = torch.where(adv, h + tc, h)
        brk = torch.where(active, brk_n, brk)
        mdo = torch.where(active[:, None], mdo_n, mdo)
    st2 = st.replace(pos=pos, quat=qt, q_art=qa, min_dist_obs=mdo)

    # forward dynamics + semi-implicit velocity update
    # controller hook (ControlledBody::controller, src/Simulator.cpp:339-348):
    # returns generalized forces (B, ngc) over the gc layout: per-free-body
    # wrenches [f; τ] followed by articulated joint torques
    tau = None
    u_free = None
    if controller is not None:
        u = controller(scene, st2)
        nb6 = 6 * scene.nb
        if scene.nb:
            u_free = u[:, :nb6].reshape(B, scene.nb, 6)
        if scene.nv_art:
            tau = u[:, nb6:]
    a_lin, a_ang = forward_dynamics_free(scene, st2.quat, st2.omega, st2.vel)
    if u_free is not None:
        a_lin = a_lin + scene.inv_mass[:, None] * u_free[..., :3]
        Rc = quat.to_matrix(st2.quat)
        Iinv_w = Rc @ scene.inv_inertia @ Rc.transpose(-1, -2)
        a_ang = a_ang + (Iinv_w @ u_free[..., 3:, None])[..., 0]
    qdd = articulated_qdd(scene, st2, tau)
    nb = scene.nb

    def split_gc(a_gc):
        """A gc vector (B, ngc) as (free linear, free angular, joint) parts."""
        ab6 = a_gc[:, : 6 * nb].reshape(B, nb, 6)
        return ab6[..., :3], ab6[..., 3:], a_gc[:, 6 * nb:]

    if scene.has_compliant:
        # compliant (penalty) contact forces applied before the velocity
        # update (calc_compliant_unilateral_constraint_forces)
        pt_c = kinematics.compute(scene, st2)
        _, con_c = nph.narrow_phase(
            scene, pt_c.pos, pt_c.quat, scene.contact_dist_thresh)
        f_gc = penalty_forces(scene, pt_c, con_c)
        Minv_c = impact.gc_inv_inertia(scene, st2, st2.quat)
        ap_lin, ap_ang, ap_art = split_gc((Minv_c @ f_gc[..., None])[..., 0])
        a_lin, a_ang, qdd = a_lin + ap_lin, a_ang + ap_ang, qdd + ap_art

    if scene.bilaterals:
        # acceleration-level KKT for implicit bilateral constraints
        # (Simulator::solve, src/Simulator.cpp:604-805)
        J, _ = bilateral.constraint_rows(
            scene, st2, kinematics.compute(scene, st2))
        jd = bilateral.jdot_qd(scene, st2)
        Minv = impact.gc_inv_inertia(scene, st2, st2.quat)
        a_gc = torch.cat([torch.cat([a_lin, a_ang], dim=-1).reshape(B, 6 * nb),
                          qdd], dim=1)
        a_lin, a_ang, qdd = split_gc(
            bilateral.acceleration_correction(Minv, J, a_gc, jd))

    hh = h[:, None, None]
    vel = st2.vel + a_lin * hh
    omega = st2.omega + a_ang * hh
    qd_art = st2.qd_art + qdd * h[:, None]

    # dissipation (src/Dissipation.cpp:30-55)
    lam = scene.dissipation_lambda[:, None]
    st2 = st2.replace(vel=vel * lam, omega=omega * lam, qd_art=qd_art)

    # contacts at the new configuration + impact resolution
    if scene.n_contacts or scene.n_limits:
        pt = kinematics.compute(scene, st2)
        _, con = nph.narrow_phase(
            scene, pt.pos, pt.quat, scene.contact_dist_thresh)
        if scene.has_compliant:
            # compliant contacts are handled by the penalty forces, not the
            # rigid impact LCP (find_unilateral_constraints' rigid/compliant
            # split, ConstraintSimulator.cpp:510-520)
            con = con._replace(active=con.active & ~scene.slot_compliant)
        res = _resolve(scene, st2, pt, con, st.zlast, st.zlast_active, cascade)
        st2 = kinematics.apply_gc_velocity_delta(scene, st2, res.dv)
        st2 = st2.replace(zlast=res.zlast, zlast_active=res.zlast_active)
        if res.pivots is not None and st2.solver_pivots is not None:
            # solver-effort observability (reference pivot counters,
            # include/Moby/LCP.h:30) accumulated across mini-steps
            st2 = st2.replace(
                solver_pivots=st2.solver_pivots + res.pivots,
                solver_fallbacks=st2.solver_fallbacks + res.fallbacks,
            )

    st2 = st2.replace(time=st.time + h)
    return st2, h


def _resolve(scene, st, pt, con, zlast, zlast_active, cascade):
    """The impact handler, in apply_model's dispatch order: all-infinite-mu
    no-slip first (src/ImpactConstraintHandler.cpp:123-131), then the NQP
    when any contact has the true cone (use_qp_solver :563), else the QP.
    Scenes whose contact slots disagree on the model route *per island*
    (the per-connected-group dispatch, :113-151): each model solves only its
    islands' constraints and the velocity deltas and counters sum — islands
    are decoupled, so this equals per-group solves."""
    args = (scene, st, pt, con, zlast, zlast_active)
    if not scene.mixed_models:
        resolve = (noslip.resolve_impacts_noslip if scene.use_noslip
                   else nqp.resolve_impacts_nqp if scene.use_nqp
                   else impact.resolve_impacts)
        return resolve(*args, cascade=cascade)
    (f_ns, l_ns), (f_nqp, l_nqp), (f_qp, l_qp) = impact.model_masks(scene, con)
    res = impact.resolve_impacts(*args, act_filter=f_qp, lim_filter=l_qp,
                                 cascade=cascade)
    parts = [noslip.resolve_impacts_noslip(
        *args, act_filter=f_ns, lim_filter=l_ns, cascade=cascade)]
    if scene.use_nqp:
        parts.append(nqp.resolve_impacts_nqp(
            *args, act_filter=f_nqp, lim_filter=l_nqp, cascade=cascade))
    dv, imp_n, piv, fb = res.dv, res.impulses_n, res.pivots, res.fallbacks
    for r in parts:
        dv, imp_n = dv + r.dv, imp_n + r.impulses_n
        piv, fb = piv + r.pivots, fb + r.fallbacks
    return impact.ImpactResult(dv, res.zlast, res.zlast_active, imp_n, piv, fb)


def _select_state(active, new: sc.State, old: sc.State) -> sc.State:
    """Per-scenario select over every field of the state."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if a is None or a is b:
            out[f.name] = a
        else:
            out[f.name] = torch.where(
                active.reshape(active.shape + (1,) * (a.dim() - 1)), a, b)
    return sc.State(**out)


def step(scene: sc.Scene, st: sc.State, dt, controller=None, device="cuda",
         cascade=None) -> sc.State:
    """One full simulator step (TimeSteppingSimulator::step) of every
    scenario of the batch. `device` states where the caller expects to run
    (the card unless "cpu" is asked for) and raises when the state lives
    elsewhere; `cascade` is handed to the LCP solves (see `solvers.lcp`)."""
    _check_device(st.pos, device)
    _refuse_unported(scene)
    dtype = st.pos.dtype
    B = st.pos.shape[0]
    dt = torch.as_tensor(dt, dtype=dtype, device=st.pos.device)

    if st.solver_pivots is not None:
        # per-step counters: reset at step entry
        zero = torch.zeros(B, dtype=torch.int32, device=st.pos.device)
        st = st.replace(solver_pivots=zero, solver_fallbacks=zero.clone())

    # progress floor: the (MAX_MINI_STEPS x MAX_CA_ITERS) iteration budget
    # must always be able to cover dt, so a crawling CA bound cannot drop
    # simulated time (see do_mini_step). 2x headroom for the budget spent on
    # genuine impact mini-steps (h = 0 break iterations).
    tc_floor = dt / (MAX_MINI_STEPS * MAX_CA_ITERS // 2)

    h_total = st.pos.new_zeros(B)
    for _ in range(MAX_MINI_STEPS):
        active = h_total < dt
        if not bool(active.any()):
            break
        st_n, h = do_mini_step(
            scene, st, dt - h_total, controller, tc_floor=tc_floor,
            cascade=cascade)
        st = _select_state(active, st_n, st)
        h_total = torch.where(active, h_total + h, h_total)

    return stabilization.stabilize(scene, st, cascade=cascade)


def rollout(scene: sc.Scene, st: sc.State, dt, n_steps: int, controller=None,
            device="cuda", cascade=None):
    """Step a trajectory; returns (final state, stacked (pos, quat, q_art)),
    each (n_steps, B, ...)."""
    traj = []
    for _ in range(n_steps):
        st = step(scene, st, dt, controller, device=device, cascade=cascade)
        traj.append((st.pos, st.quat, st.q_art))
    return st, tuple(torch.stack(x) for x in zip(*traj))
