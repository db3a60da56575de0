"""Differentiable contact dynamics step for MPC / trajectory optimization
(counterpart of ``moby_tpu/mpc/diffstep.py``).

The regression-faithful stepper (`sim.stepper.step`) has data-dependent
loops (conservative advancement, stabilization) that block reverse-mode
differentiation. This module provides the MPC-grade step: fixed step size
(no CA sub-stepping — MPC steps are small), one impact solve through the
IFT-differentiable LCP (`solvers.difflcp`), no stabilization loop. Controls
enter as generalized forces u (B, scene.ngc): wrenches on free bodies, then
joint forces of the articulated bodies.

Every array carries the batch of scenarios as its leading dimension. The
step is differentiable by `torch.autograd`: the live solve and the replayed
solves are `torch.autograd.Function`s, everything else is plain tensor code.
The replay through `solve_lcp_given` is differentiable in forward mode as
well (`torch.autograd.forward_ad`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import scene as sc
from ..geometry import narrowphase as nph
from ..math import quaternion as quat
from ..sim import impact, kinematics
from ..sim.stepper import articulated_qdd, forward_dynamics_free, integrate_art_q
from ..solvers.difflcp import (
    DEFAULT_OPTIONS,
    MPCOptions,
    solve_lcp_diff_mpc,
    solve_lcp_given,
)


def _all_ok(q):
    return torch.ones(q.shape[0], dtype=torch.bool, device=q.device)


def _diff_lcp(options: MPCOptions = DEFAULT_OPTIONS):
    """The live LCP solver of the step: the MPC cascade with IFT gradients."""

    def solver(M, q, mask, z0, skip=None):
        return solve_lcp_diff_mpc(M, q, mask, z0, skip, options), _all_ok(q)

    return solver


def _replay_lcp(z_rec, options: MPCOptions = DEFAULT_OPTIONS):
    """LCP 'solver' that replays a recorded solution (same IFT gradients in
    both modes, zero pivot iterations). Only valid for single-solve scenes
    (all restitution zero — the gated second solve would need its own
    record)."""

    def solver(M, q, mask, z0, skip=None):
        return solve_lcp_given(M, q, mask, z_rec, options), _all_ok(q)

    return solver


def replay_ok(scene: sc.Scene) -> bool:
    """True when a dstep performs exactly one LCP solve (the eps_all_zero
    fast path of resolve_impacts), so record/replay linearization is exact."""
    K = scene.n_contacts
    eps0 = K == 0 or float(np.max(scene.host["slot_eps"])) == 0.0
    lim0 = scene.n_limits == 0 or float(np.max(scene.host["lim_eps"])) == 0.0
    return eps0 and lim0


def dstep_pre(scene: sc.Scene, st: sc.State, dt, u=None) -> sc.State:
    """The smooth half of `dstep`: semi-implicit pose integration + forces
    + dissipation — everything BEFORE contact resolution. Split out so the
    block-sparse MPC linearizer (`contact_mpc`'s `f_jac`) can chain its
    Jacobian with the contact half's. Articulated bodies take the joint
    forces u[:, 6·nb:] through Featherstone's ABA."""
    B = st.pos.shape[0]

    # position integration (semi-implicit: old velocities)
    qdot = quat.deriv(st.quat, st.omega)
    pos = st.pos + st.vel * dt
    quat_b = quat.normalize(st.quat + qdot * dt)
    q_art = integrate_art_q(scene, st.q_art, st.qd_art, dt)
    st2 = st.replace(pos=pos, quat=quat_b, q_art=q_art)

    # forward dynamics with controls
    a_lin, a_ang = forward_dynamics_free(scene, st2.quat, st2.omega)
    if u is not None and scene.nb:
        ub = u[:, : 6 * scene.nb].reshape(B, scene.nb, 6)
        a_lin = a_lin + scene.inv_mass[:, None] * ub[..., :3]
        # torque→α only for statically-live bodies (disabled fixtures get
        # zero columns from the control expansion anyway)
        il = impact._live_free_idx(scene)
        if len(il):
            R = quat.to_matrix(st2.quat[:, il])
            Iinv_w = R @ scene.inv_inertia[il] @ R.transpose(-1, -2)
            da = (Iinv_w @ ub[:, il, 3:, None])[..., 0]
            if len(il) == scene.nb:
                a_ang = a_ang + da
            else:
                il_t = sc.cached(
                    scene, ("live_idx", str(st.pos.device)),
                    lambda: torch.as_tensor(il, device=st.pos.device))
                a_ang = a_ang.index_add(1, il_t, da)
    vel = st2.vel + a_lin * dt
    omega = st2.omega + a_ang * dt

    qd_art = st2.qd_art
    if scene.nv_art:
        tau = u[:, 6 * scene.nb:] if u is not None else None
        qd_art = qd_art + articulated_qdd(scene, st2, tau) * dt

    lam = scene.dissipation_lambda[:, None]
    return st2.replace(vel=vel * lam, omega=omega * lam, qd_art=qd_art)


def contact_dv_replay(scene: sc.Scene, st2: sc.State, z,
                      options: MPCOptions = DEFAULT_OPTIONS):
    """gc-velocity delta of the contact half of `dstep` at a pose-integrated
    pre-contact state `st2`, replaying the recorded solution z: the
    block-sparse linearizer differentiates it by forward passes."""
    pt = kinematics.compute(scene, st2)
    _, con = nph.narrow_phase(scene, pt.pos, pt.quat, scene.contact_dist_thresh)
    res = impact.resolve_impacts(
        scene, st2, pt, con,
        torch.zeros_like(st2.zlast), torch.zeros_like(st2.zlast_active),
        lcp_solver=_replay_lcp(z, options),
    )
    return res.dv


def dstep(scene: sc.Scene, st: sc.State, dt, u=None, lcp_given=None,
          return_z=False, options: MPCOptions = DEFAULT_OPTIONS):
    """One differentiable step of every scenario. u: optional (B, ngc)
    generalized force. lcp_given: optional recorded LCP solution (see
    `_replay_lcp`); callers must ensure `replay_ok(scene)`. return_z: also
    return the LCP solution actually applied this step (zero when gated) for
    record/replay."""
    st2 = dstep_pre(scene, st, dt, u)

    z_step = torch.zeros_like(st.zlast)
    if scene.n_contacts or scene.n_limits:
        pt = kinematics.compute(scene, st2)
        _, con = nph.narrow_phase(
            scene, pt.pos, pt.quat, scene.contact_dist_thresh)
        res = impact.resolve_impacts(
            scene, st2, pt, con, st.zlast, st.zlast_active,
            lcp_solver=(_diff_lcp(options) if lcp_given is None
                        else _replay_lcp(lcp_given, options)),
        )
        st2 = kinematics.apply_gc_velocity_delta(scene, st2, res.dv)
        st2 = st2.replace(zlast=res.zlast, zlast_active=res.zlast_active)
        z_step = res.z_step

    st2 = st2.replace(time=st.time + dt)
    if return_z:
        return st2, z_step
    return st2


def rollout(scene: sc.Scene, st: sc.State, us, dt,
            options: MPCOptions = DEFAULT_OPTIONS):
    """Differentiable rollout: us (H, B, ngc) -> (final state, the list of
    per-step states)."""
    states = []
    for u in us:
        st = dstep(scene, st, dt, u, options=options)
        states.append(st)
    return st, states


def state_vector(scene: sc.Scene, st: sc.State):
    """Flatten the dynamic state (positions + velocities) for costs, (B, ·)."""
    B = st.pos.shape[0]
    parts = []
    if scene.nb:
        parts += [st.pos.reshape(B, -1), st.quat.reshape(B, -1),
                  st.vel.reshape(B, -1), st.omega.reshape(B, -1)]
    if scene.nq_art:
        parts.append(st.q_art)
    if scene.nv_art:
        parts.append(st.qd_art)
    return torch.cat(parts, dim=1)
