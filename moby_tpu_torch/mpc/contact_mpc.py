"""Contact-MPC harness: scene-level state packing + batched iLQR solves
(counterpart of ``moby_tpu/mpc/contact_mpc.py``: `solve_batch`).

`make_dynamics` closes a compiled Scene over `diffstep.dstep` as a
vector-space dynamics f(x, u) of a whole batch; `solve_batch` runs
`ilqr.ilqr_batched` on it.

The optimization state covers ENABLED bodies only: disabled bodies (ground
planes, fixtures) are constants of the scene, so packing them would double
nx/nu with dead coordinates. Their state comes from the template at unpack.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import scene as sc
from ..solvers.difflcp import DEFAULT_OPTIONS, MPCOptions
from ..solvers.lcp import _check_device
from . import diffstep, ilqr


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
    zero pivot iterations.

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
    return f, f_record, f_replay


class MPCProblem(NamedTuple):
    scene: sc.Scene
    template: sc.State     # a state of batch 1
    dt: float
    horizon: int


def solve_batch(
    prob: MPCProblem,
    states: sc.State,
    cost,
    cost_final,
    us0=None,
    n_iters: int = 10,
    record_replay: bool = True,
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
    x0s = pack(scene, states)
    nu = n_controls(scene)
    if us0 is None:
        us0 = x0s.new_zeros((prob.horizon, nu))
    return ilqr.ilqr_batched(
        f, cost, cost_final, x0s, us0, n_iters=n_iters, mu_init=mu_init,
        line_search_steps=options.line_search_steps,
        f_record=f_rec, f_replay=f_rep,
    )
