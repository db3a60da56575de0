"""Contact-MPC harness: scene-level state packing + iLQR solves
(counterpart of ``moby_tpu/mpc/contact_mpc.py``: `solve`, `solve_batch`).

`make_dynamics` closes a compiled Scene over `diffstep.dstep` as a
vector-space dynamics f(x, u) of a whole batch; `solve` runs `ilqr.ilqr` on
it for one scenario, `solve_batch` runs `ilqr.ilqr_batched` for many.

The optimization state covers ENABLED bodies only: disabled bodies (ground
planes, fixtures) are constants of the scene, so packing them would double
nx/nu with dead coordinates. Their state comes from the template at unpack.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import scene as sc
from ..math import quaternion as quat_m
from ..solvers.difflcp import DEFAULT_OPTIONS, MPCOptions
from ..solvers.lcp import _check_device
from . import diffstep, ilqr

# device memory the hoisted linearization may take at once (an 80 GB card
# also holds the rollouts, the recorded solutions and the allocator's cache)
HOIST_BUDGET_BYTES = 40 * 2 ** 30


def _enabled_idx(scene: sc.Scene) -> np.ndarray:
    """Static indices of the enabled (dynamic) free bodies."""
    return np.nonzero(scene.host["enabled"])[0]


def n_controls(scene: sc.Scene) -> int:
    """Control dimension: wrenches on enabled free bodies + joint forces."""
    return 6 * len(_enabled_idx(scene)) + scene.nv_art


def state_sizes(scene: sc.Scene):
    ne = len(_enabled_idx(scene))
    return (3 * ne, 4 * ne, 3 * ne, 3 * ne, scene.nq_art, scene.nv_art)


def pack(scene: sc.Scene, st: sc.State):
    """(B, nx): [pos, quat, vel, omega] of the enabled bodies, then the
    articulated coordinates."""
    idx = _enabled_idx(scene)
    B = st.pos.shape[0]
    parts = []
    if len(idx):
        parts += [
            st.pos[:, idx].reshape(B, -1), st.quat[:, idx].reshape(B, -1),
            st.vel[:, idx].reshape(B, -1), st.omega[:, idx].reshape(B, -1),
        ]
    parts += [st.q_art, st.qd_art]
    return torch.cat(parts, dim=1)


def _merge_bodies(scene, template_arr, idx, new_vals):
    """Replace body rows `idx` of template_arr (1 or B, nb, ·) with new_vals
    (B, ne, ·) via a static concat + permutation gather (no scatter)."""
    nb = scene.nb
    if len(idx) == nb:
        return new_vals
    other = np.setdiff1d(np.arange(nb), idx)
    perm = np.argsort(np.concatenate([idx, other]))
    B = new_vals.shape[0]
    rest = template_arr[:, other].expand((B, len(other)) + template_arr.shape[2:])
    return torch.cat([new_vals, rest], dim=1)[:, perm]


def unpack(scene: sc.Scene, template: sc.State, x):
    """The State of a batch from x (B, nx); everything x does not hold comes
    from `template` (a state of batch 1 or B)."""
    idx = _enabled_idx(scene)
    ne = len(idx)
    B = x.shape[0]
    o = 0
    st = template if template.batch == B else _expand_views(template, B)
    if ne:
        pos = x[:, o: o + 3 * ne].reshape(B, ne, 3)
        quat = x[:, o + 3 * ne: o + 7 * ne].reshape(B, ne, 4)
        vel = x[:, o + 7 * ne: o + 10 * ne].reshape(B, ne, 3)
        omega = x[:, o + 10 * ne: o + 13 * ne].reshape(B, ne, 3)
        st = st.replace(
            pos=_merge_bodies(scene, template.pos, idx, pos),
            quat=_merge_bodies(scene, template.quat, idx, quat),
            vel=_merge_bodies(scene, template.vel, idx, vel),
            omega=_merge_bodies(scene, template.omega, idx, omega),
        )
        o += 13 * ne
    if scene.nq_art:
        st = st.replace(q_art=x[:, o: o + scene.nq_art])
        o += scene.nq_art
    if scene.nv_art:
        st = st.replace(qd_art=x[:, o: o + scene.nv_art])
    return st


def _expand_views(st: sc.State, B: int) -> sc.State:
    """A batch-1 state seen as a batch of B (read-only views, no copies)."""
    import dataclasses

    if st.batch != 1:
        raise ValueError(f"template of batch {st.batch} against x of batch {B}")
    return st.replace(**{
        f.name: getattr(st, f.name).expand((B,) + getattr(st, f.name).shape[1:])
        for f in dataclasses.fields(st) if getattr(st, f.name) is not None
    })


def _cold(template: sc.State) -> sc.State:
    return template.replace(
        zlast=torch.zeros_like(template.zlast),
        zlast_active=torch.zeros_like(template.zlast_active),
    )


def _control_expansion(scene: sc.Scene) -> Callable:
    """u (B, n_controls) -> (B, ngc): zero columns for disabled bodies, by a
    static concat + permutation."""
    idx = _enabled_idx(scene)
    gc_cols = np.concatenate(
        [6 * i + np.arange(6) for i in idx]
        + [6 * scene.nb + np.arange(scene.nv_art)]
    ).astype(np.int64) if (len(idx) or scene.nv_art) else np.zeros(0, np.int64)
    if len(gc_cols) == scene.ngc:
        return lambda u: u
    other = np.setdiff1d(np.arange(scene.ngc), gc_cols)
    perm = np.argsort(np.concatenate([gc_cols, other]))

    def expand(u):
        pad = u.new_zeros((u.shape[0], scene.ngc - len(gc_cols)))
        return torch.cat([u, pad], dim=1)[:, perm]

    return expand


def make_dynamics(scene: sc.Scene, template: sc.State, dt,
                  options: MPCOptions = DEFAULT_OPTIONS) -> Callable:
    """f(x (B, nx), u (B, nu)) -> x' through the differentiable contact step.

    The LCP warm-start bookkeeping is pinned (cold start) so x fully
    determines the next state. u spans enabled bodies' wrenches + joint
    forces (`n_controls`); disabled gc columns receive zero.
    """
    cold = _cold(template)
    expand = _control_expansion(scene)

    def f(x, u):
        st = unpack(scene, cold, x)
        st2 = diffstep.dstep(scene, st, dt, expand(u), options=options)
        return pack(scene, st2)

    return f


def make_dynamics_rr(scene: sc.Scene, template: sc.State, dt,
                     options: MPCOptions = DEFAULT_OPTIONS):
    """(f, f_record, f_replay) for the record/replay linearization path.

    f_record(x, u, aux) -> (x', z, aux'): the step plus the LCP solution
    it used, where aux = (zlast, zlast_active) WARM-STARTS the pivoting
    solve from the previous rollout step — the reference's own zlast
    machinery, which collapses the pivot iterations of persistent resting
    contacts to ~1. The recorded z is the actual converged solution, so the
    backward replay stays exact regardless of seeding.
    f_replay(x, u, z) -> x': the identical step with the pivoting solve
    replaced by `solve_lcp_given(z)` — same primal, same IFT gradients,
    zero pivot iterations, differentiable in both modes. f_replay.jac
    (with options.block_jac): the block-sparse linearizer
    (`_block_linearizer`).

    Returns (f, None, None) when the scene has no single-solve guarantee
    (`diffstep.replay_ok`) or no contacts at all.
    """
    f = make_dynamics(scene, template, dt, options)
    has_lcp = bool(scene.n_contacts or scene.n_limits)
    if not has_lcp or not diffstep.replay_ok(scene):
        return f, None, None

    cold = _cold(template)
    expand = _control_expansion(scene)

    def aux_init(B):
        return (template.zlast.new_zeros((B,) + template.zlast.shape[1:]),
                template.zlast_active.new_zeros(
                    (B,) + template.zlast_active.shape[1:]))

    def f_record(x, u, aux):
        st = unpack(scene, cold, x)
        st = st.replace(zlast=aux[0], zlast_active=aux[1])
        st2, z_step = diffstep.dstep(scene, st, dt, expand(u), return_z=True,
                                     options=options)
        return pack(scene, st2), z_step, (st2.zlast, st2.zlast_active)

    def f_replay(x, u, z):
        st = unpack(scene, cold, x)
        st2 = diffstep.dstep(scene, st, dt, expand(u), lcp_given=z,
                             options=options)
        return pack(scene, st2)

    f_record.aux_init = aux_init
    if options.block_jac:
        f_replay.jac = _block_linearizer(scene, cold, dt, expand, options)
    return f, f_record, f_replay


def _pose_vel_layout(scene: sc.Scene):
    """Static tables of the block-sparse linearizer: (n_pose, n_vel, the
    permutation from [pose; vel] rows to pack() order, the gc rows of the
    contact velocity delta that feed the packed velocity coordinates)."""
    idx = _enabled_idx(scene).astype(np.int64)
    ne = len(idx)
    n_pose = 7 * ne + scene.nq_art
    n_vel = 6 * ne + scene.nv_art
    # rows of [pp; vl] in pack() order (pose dims first, then vel dims)
    pose_rows = np.concatenate([
        np.arange(7 * ne), 13 * ne + np.arange(scene.nq_art)]).astype(np.int64)
    vel_rows_x = np.concatenate([
        7 * ne + np.arange(6 * ne),
        13 * ne + scene.nq_art + np.arange(scene.nv_art)]).astype(np.int64)
    perm_to_x = np.argsort(np.concatenate([pose_rows, vel_rows_x]))
    # pack order of the velocities: all enabled vels, then all omegas, then
    # qd_art
    dv_rows = np.concatenate([
        (6 * idx[:, None] + np.arange(3)[None]).reshape(-1),
        (6 * idx[:, None] + 3 + np.arange(3)[None]).reshape(-1),
        6 * scene.nb + np.arange(scene.nv_art, dtype=np.int64),
    ]).astype(np.int64)
    return n_pose, n_vel, perm_to_x, dv_rows


def _pack_pv(scene: sc.Scene, st: sc.State):
    """(pose (B, n_pose), vel (B, n_vel)) of the packed coordinates."""
    idx = _enabled_idx(scene)
    B = st.pos.shape[0]
    pose, vel = [], []
    if len(idx):
        pose += [st.pos[:, idx].reshape(B, -1), st.quat[:, idx].reshape(B, -1)]
        vel += [st.vel[:, idx].reshape(B, -1), st.omega[:, idx].reshape(B, -1)]
    pose.append(st.q_art)
    vel.append(st.qd_art)
    return torch.cat(pose, dim=1), torch.cat(vel, dim=1)


def _unpack_pv(scene: sc.Scene, cold: sc.State, pp, vl):
    idx = _enabled_idx(scene)
    ne = len(idx)
    B = pp.shape[0]
    st = cold if cold.batch == B else _expand_views(cold, B)
    if ne:
        st = st.replace(
            pos=_merge_bodies(scene, cold.pos, idx, pp[:, :3 * ne].reshape(B, ne, 3)),
            quat=_merge_bodies(scene, cold.quat, idx,
                               pp[:, 3 * ne: 7 * ne].reshape(B, ne, 4)),
            vel=_merge_bodies(scene, cold.vel, idx, vl[:, :3 * ne].reshape(B, ne, 3)),
            omega=_merge_bodies(scene, cold.omega, idx,
                                vl[:, 3 * ne: 6 * ne].reshape(B, ne, 3)),
        )
    if scene.nq_art:
        st = st.replace(q_art=pp[:, 7 * ne:])
    if scene.nv_art:
        st = st.replace(qd_art=vl[:, 6 * ne:])
    return st


def _block_linearizer(scene: sc.Scene, cold: sc.State, dt, expand,
                      options: MPCOptions):
    """f_jac(x, u, z) -> (A, B): the replay step's Jacobians, equal to forward
    mode through the whole replay step, assembled blockwise.

    The step factors as x' = [pp; vl + dv(pp, vl, z)] with (pp, vl) the
    pose-integrated state and pre-contact velocities (`diffstep.dstep_pre`)
    and dv the contact half (`diffstep.contact_dv_replay`). The contact
    half's Jacobian is block-sparse: the geometry-heavy path (kinematics,
    narrow phase, contact Jacobians, Delassus) depends ONLY on the n_pose
    pose coordinates, while velocity tangents reach dv only through the LCP
    right-hand side. Two separate forward passes, one with the pose tangents
    (n_pose replicas) and one with the velocity tangents (n_vel), then
    chain the blocks with small matmuls.

    u never moves the pose half of the pre-contact step, and for free-body
    scenes its velocity block is known in closed form:
    ∂vel/∂u_lin = dt·m⁻¹·λ·I₃, ∂ω/∂u_ang = dt·λ·I⁻¹_w(quat'), so the first
    stage takes tangents in x only. Articulated scenes take forward mode
    over u too (∂q̇'/∂τ needs H(q)⁻¹)."""
    n_pose, n_vel, perm_to_x, dv_rows = _pose_vel_layout(scene)
    idx = _enabled_idx(scene)
    ne = len(idx)
    analytic_u = not scene.arts
    dt_c = float(dt)
    perm_to_x = torch.as_tensor(perm_to_x, device=cold.pos.device)
    dv_rows_t = torch.as_tensor(dv_rows, device=cold.pos.device)

    def pre(x_, u_):
        st2 = diffstep.dstep_pre(scene, unpack(scene, cold, x_), dt, expand(u_))
        return _pack_pv(scene, st2)

    def contact(pp_, vl_, z_):
        st2 = _unpack_pv(scene, cold, pp_, vl_)
        return diffstep.contact_dv_replay(scene, st2, z_, options)[:, dv_rows_t]

    def f_jac(x, u, z):
        B, nu = u.shape
        dtype = x.dtype
        if analytic_u:
            (pp, vl), ((J1p_x,), (J1v_x,)) = ilqr.jacfwd(
                lambda x_, u_: pre(x_, u_), (x, u), (0,))
            J1p_u = x.new_zeros((B, n_pose, nu))
            q2 = pp[:, 3 * ne: 7 * ne].reshape(B, ne, 4)
            R = quat_m.to_matrix(q2)
            Iinv_w = R @ scene.inv_inertia[idx] @ R.transpose(-1, -2)
            lam = scene.dissipation_lambda[idx]
            J1v_u = x.new_zeros((B, n_vel, nu))
            eye3 = torch.eye(3, dtype=dtype, device=x.device)
            for j in range(ne):
                c = dt_c * lam[j]
                J1v_u[:, 3 * j: 3 * j + 3, 6 * j: 6 * j + 3] = \
                    c * scene.inv_mass[idx[j]] * eye3
                J1v_u[:, 3 * ne + 3 * j: 3 * ne + 3 * j + 3, 6 * j + 3: 6 * j + 6] = \
                    c * Iinv_w[:, j]
        else:
            (pp, vl), ((J1p_x, J1p_u), (J1v_x, J1v_u)) = ilqr.jacfwd(
                pre, (x, u), (0, 1))
        # two SEPARATE forward passes so that each sees the block sparsity
        _, (Dp,) = ilqr.jacfwd(contact, (pp, vl), (0,), z)      # (B, n_vel, n_pose)
        _, (Dv,) = ilqr.jacfwd(contact, (pp, vl), (1,), z)      # (B, n_vel, n_vel)
        vx = J1v_x + Dp @ J1p_x + Dv @ J1v_x
        vu = J1v_u + Dp @ J1p_u + Dv @ J1v_u
        A = torch.cat([J1p_x, vx], dim=1)[:, perm_to_x]
        Bm = torch.cat([J1p_u, vu], dim=1)[:, perm_to_x]
        return A, Bm

    return f_jac


def hoist_step_bytes(scene: sc.Scene, B: int, dtype, linearize_fwd: bool = False,
                     options: MPCOptions = DEFAULT_OPTIONS):
    """(replicas, bytes) of one time step of the hoisted linearization at
    batch B, by the memory model of `hoist_chunks`."""
    nx = sum(state_sizes(scene))
    nu = n_controls(scene)
    if linearize_fwd and options.block_jac:
        n_pose, n_vel, _, _ = _pose_vel_layout(scene)
        reps = max(nx if not scene.arts else nx + nu, n_pose, n_vel)
    elif linearize_fwd:
        reps = nx + nu
    else:
        reps = nx
    n = scene.n_lcp
    itemsize = torch.finfo(dtype).bits // 8
    replica = itemsize * (REPLICA_MATRICES * n * n + REPLICA_SCALARS)
    return B * reps, B * reps * replica


def hoist_chunks(scene: sc.Scene, B: int, H: int, dtype,
                 linearize_fwd: bool = False,
                 options: MPCOptions = DEFAULT_OPTIONS) -> int:
    """The fewest chunks of whole time steps whose hoisted linearization
    stays under HOIST_BUDGET_BYTES, from the sizes alone.

    Memory model of one replica of the step (one member, one tangent or
    cotangent direction): REPLICA_MATRICES matrices of the LCP's n × n
    (the Delassus and KKT matrices, the padded copies and the IFT inverse
    that the linearization keeps) plus REPLICA_SCALARS numbers of the rest.
    Reverse mode keeps nx replicas of the graph a member; forward mode
    (nx + nu replicas, or the block linearizer's largest pass) keeps no
    graph, but the same model bounds its transient tensors. On an H100 in
    float32, the hoisted linearization took above the unhoisted solve's
    peak 61.6 KB a replica on block-push (n=64; 48.8 KB in forward mode)
    and 4.0 KB on ball-push (n=8): the model allows 1.6 and 4.4 times
    that."""
    _, per_step = hoist_step_bytes(scene, B, dtype, linearize_fwd, options)
    steps = max(1, min(H, HOIST_BUDGET_BYTES // max(1, per_step)))
    return -(-H // steps)


# the memory model's constants (see `hoist_chunks`)
REPLICA_MATRICES = 5
REPLICA_SCALARS = 4096


class MPCProblem(NamedTuple):
    scene: sc.Scene
    template: sc.State     # a state of batch 1
    dt: float
    horizon: int


def solve(
    prob: MPCProblem,
    st: sc.State,
    cost,
    cost_final,
    us0=None,
    n_iters: int = 10,
    parallel_line_search: bool = True,
    options: MPCOptions = DEFAULT_OPTIONS,
    device="cuda",
) -> ilqr.ILQRResult:
    """One contact-MPC solve of one scenario through `ilqr.ilqr`: st is a
    State of batch 1; cost(x, u) and cost_final(x) take batched tensors, as
    in `solve_batch`. Returns us (H, nu), xs (H+1, nx) and a scalar cost.
    The backward pass linearizes the full differentiable step (its live
    LCP solve, `solve_lcp_diff_mpc`, included).

    parallel_line_search: every step size in one rollout of one member per
    step size (see `ilqr.ilqr`). device: where the caller expects to run;
    raises when `st` lives elsewhere."""
    _check_device(st.pos, device)
    if st.batch != 1:
        raise ValueError(f"solve takes one scenario, not a batch of {st.batch}")
    scene = prob.scene
    f = make_dynamics(scene, prob.template, prob.dt, options)
    x0 = pack(scene, st)[0]
    if us0 is None:
        us0 = x0.new_zeros((prob.horizon, n_controls(scene)))
    return ilqr.ilqr(
        f, cost, cost_final, x0, us0, n_iters=n_iters,
        line_search_steps=options.line_search_steps,
        parallel_line_search=parallel_line_search)


def solve_batch(
    prob: MPCProblem,
    states: sc.State,
    cost,
    cost_final,
    us0=None,
    n_iters: int = 10,
    record_replay: bool = True,
    hoist_linearization: bool = False,
    linearize_fwd: bool = False,
    rr_warm_start: bool = True,
    mu_init: float = 1e-6,
    options: MPCOptions = DEFAULT_OPTIONS,
    device="cuda",
) -> ilqr.ILQRResult:
    """Batched contact-MPC solve through `ilqr.ilqr_batched`, with the
    batch-voted early-exit line search.

    states: the initial State of every scenario (batch B). cost(x, u) and
    cost_final(x) take batched tensors, (B, nx), (B, nu) -> (B,).

    record_replay: rollouts record their LCP solutions and the backward
    pass replays them through the IFT pullback instead of re-running the
    pivoting solve (identical Jacobians). Off by itself for scenes where a
    step can solve twice (nonzero restitution).
    hoist_linearization: all H step Jacobians before the Riccati recursion,
    in the fewest chunks of whole time steps that `hoist_chunks` allows.
    linearize_fwd: step Jacobians by forward mode through the replay
    (`options.block_jac` selects the block-sparse linearizer); needs
    record/replay, and is off by itself when replay is unavailable.
    options.riccati_bf16: see `ilqr._riccati_step`.
    rr_warm_start: thread (zlast, zlast_active) across rollout steps.
    Warm-started pivoting takes a different pivot path and converges to the
    same solution only up to the LCP termination tolerance, so rollouts
    drift at that level against the cold-start path. False gives parity with
    record_replay=False.
    device: where the caller expects to run; raises when `states` lives
    elsewhere.
    """
    _check_device(states.pos, device)
    scene = prob.scene
    f, f_rec, f_rep = make_dynamics_rr(scene, prob.template, prob.dt, options)
    if not record_replay:
        f_rec = f_rep = None
    if f_rec is not None and not rr_warm_start:
        f_rec_warm = f_rec

        def f_rec(x, u, aux):
            xp, z, _ = f_rec_warm(x, u, f_rec_warm.aux_init(x.shape[0]))
            return xp, z, aux

        f_rec.aux_init = f_rec_warm.aux_init
    if f_rep is None:
        linearize_fwd = False
    x0s = pack(scene, states)
    nu = n_controls(scene)
    if us0 is None:
        us0 = x0s.new_zeros((prob.horizon, nu))
    chunks = hoist_chunks(scene, x0s.shape[0], prob.horizon, x0s.dtype,
                          linearize_fwd, options) if hoist_linearization else 1
    return ilqr.ilqr_batched(
        f, cost, cost_final, x0s, us0, n_iters=n_iters, mu_init=mu_init,
        line_search_steps=options.line_search_steps,
        f_record=f_rec, f_replay=f_rep,
        hoist_linearization=hoist_linearization, hoist_chunks=chunks,
        linearize_fwd=linearize_fwd, riccati_bf16=options.riccati_bf16,
    )
