"""Batched iLQR trajectory optimizer over the differentiable contact dynamics
(counterpart of ``moby_tpu/mpc/ilqr.py``: `ilqr_batched`).

The contact-MPC outer loop: iterative LQR with step Jacobians obtained by
reverse-mode differentiation through `mpc.diffstep` (contact LCP included,
via the IFT autograd Functions of `solvers.difflcp`), a Riccati backward
recursion with Levenberg-style regularization, and a batch-voted
backtracking forward line search.

The batch of scenarios is the leading dimension of every array, and every
function handed in works on the whole batch:

    f(x (B, nx), u (B, nu)) -> x' (B, nx)
    cost(x (B, nx), u (B, nu)) -> (B,)        cost_final(x (B, nx)) -> (B,)

Members are independent of each other, which is what the Jacobians rely on
(see `_jacobians`). Loops are Python loops; the line search asks the device
once per step size whether every member has accepted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..solvers.lcp import gj_invert_pd


class ILQRResult(NamedTuple):
    us: torch.Tensor       # (B, H, nu) optimized controls
    xs: torch.Tensor       # (B, H+1, nx) optimized trajectory
    cost: torch.Tensor     # (B,) final cost
    n_iters: int


def _pd_inverse(M):
    """(Minv, pd_ok) for the Riccati Quu solve.

    float32 (the card's execution dtype) routes through the Gauss–Jordan
    with the signed-pivot PD check; float64 (CPU regression mode) keeps the
    LAPACK pair Cholesky + inverse."""
    if M.dtype == torch.float32:
        return gj_invert_pd(M)
    _, info = torch.linalg.cholesky_ex(M)
    Minv, _ = torch.linalg.inv_ex(M)
    return Minv, info == 0


def _jacobians(step: Callable, x, u, *extra):
    """(A (B, nx, nx), B (B, nx, nu)) = (∂x'/∂x, ∂x'/∂u) of
    x' = step(x, u, *extra), for every member of the batch.

    Members are independent, so row i of every member's Jacobian is the
    gradient of Σ_b x'[b, i]. The batch is replicated once per output row
    (nx·B members), stepped ONCE, and one backward pass with a one-hot
    cotangent per replica gives all rows: one forward and one backward graph
    of launches instead of nx backward passes over the same graph."""
    B, nx = x.shape
    nu = u.shape[1]

    def rep(t):
        return t.unsqueeze(0).expand((nx,) + t.shape).reshape(
            (nx * B,) + t.shape[1:])

    with torch.enable_grad():
        xr = rep(x.detach()).requires_grad_(True)
        ur = rep(u.detach()).requires_grad_(True)
        y = step(xr, ur, *(rep(e.detach()) for e in extra))    # (nx·B, nx)
        rows = y.reshape(nx, B, nx).diagonal(dim1=0, dim2=2)    # (B, nx): y_i of replica i
        gx, gu = torch.autograd.grad(rows.sum(), (xr, ur), allow_unused=True)
    if gx is None:
        gx = torch.zeros_like(xr)
    if gu is None:
        gu = torch.zeros_like(ur)
    A = gx.reshape(nx, B, nx).transpose(0, 1)
    Bm = gu.reshape(nx, B, nu).transpose(0, 1)
    return A, Bm


def _cost_derivatives(cost: Callable, x, u):
    """(cx, cu, cxx, cuu, cux) of a batched stage cost at (x, u): (N, nx),
    (N, nu), (N, nx, nx), (N, nu, nu), (N, nu, nx). The cost is a small pure
    function, differentiated per member by `torch.func`."""
    from torch.func import grad, hessian, jacrev, vmap

    def one(x1, u1):
        return cost(x1[None], u1[None])[0]

    cx, cu = vmap(grad(one, argnums=(0, 1)))(x, u)
    cxx = vmap(hessian(one, argnums=0))(x, u)
    cuu = vmap(hessian(one, argnums=1))(x, u)
    cux = vmap(jacrev(grad(one, argnums=1), argnums=0))(x, u)
    return cx, cu, cxx, cuu, cux


def _final_derivatives(cost_final: Callable, x):
    from torch.func import grad, hessian, vmap

    def one(x1):
        return cost_final(x1[None])[0]

    return vmap(grad(one))(x), vmap(hessian(one))(x)


def ilqr_batched(
    f: Callable,
    cost: Callable,
    cost_final: Callable,
    x0s: torch.Tensor,
    us0: torch.Tensor,
    n_iters: int = 10,
    mu_init: float = 1e-6,
    line_search_steps: int = 8,
    f_record: Optional[Callable] = None,
    f_replay: Optional[Callable] = None,
) -> ILQRResult:
    """Batch-level iLQR with a batch-voted early-exit backtracking line
    search: step sizes are walked largest-first and the walk ends as soon as
    every member has found an improving step (accept-first-improving per
    member; members that already accepted stop updating).

    x0s (B, nx); us0 (B, H, nu) or (H, nu) broadcast.

    Record/replay (optional): f_record(x, u, aux) -> (x', z, aux') runs the
    same step warm-started by the carried aux (the previous step's (zlast,
    zlast_active)) and returns the contact-solve solution z actually applied;
    f_record.aux_init(B) gives the cold aux for step 0. f_replay(x, u, z)
    -> x' replays z with identical primal and IFT gradients but no pivot
    loops. The backward pass then linearizes through f_replay at the
    rollout's own solutions, which removes the LCP loops from the backward
    sweep. Rollouts run without a graph; only the linearization records one.
    """
    B, nx = x0s.shape
    if us0.dim() == 2:
        us0 = us0[None].expand((B,) + tuple(us0.shape))
    us0 = us0.contiguous()
    H, nu = us0.shape[1:]
    dtype, device = x0s.dtype, x0s.device
    rr = f_record is not None and f_replay is not None
    eye = torch.eye(nu, dtype=dtype, device=device)

    def rollout(x0s_, uss, ks=None, Ks=None, xss_ref=None, alpha=None):
        """Open-loop rollout of uss or, with gains, the controller rollout
        u = u_ref + alpha·k + K (x - x_ref). -> (xss (B, H+1, nx),
        uss (B, H, nu), zss (B, H, nz) or None)."""
        with torch.no_grad():
            x = x0s_
            aux = f_record.aux_init(B) if rr else None
            xs, us_, zs = [x0s_], [], []
            for t in range(H):
                u = uss[:, t]
                if ks is not None:
                    u = u + alpha * ks[:, t] + (
                        Ks[:, t] @ (x - xss_ref[:, t])[..., None])[..., 0]
                if rr:
                    x, z, aux = f_record(x, u, aux)
                    zs.append(z)
                else:
                    x = f(x, u)
                xs.append(x)
                us_.append(u)
            return (torch.stack(xs, dim=1), torch.stack(us_, dim=1),
                    torch.stack(zs, dim=1) if rr else None)

    def total_cost(xss, uss):
        with torch.no_grad():
            stage = cost(xss[:, :-1].reshape(B * H, nx), uss.reshape(B * H, nu))
            return stage.reshape(B, H).sum(dim=1) + cost_final(xss[:, -1])

    def backward(xss, uss, zss, mus):
        Vx, Vxx = _final_derivatives(cost_final, xss[:, -1])
        # the stage cost's derivatives at all H steps in one batched call
        cx, cu, cxx, cuu, cux = (
            d.reshape((B, H) + d.shape[1:]) for d in _cost_derivatives(
                cost, xss[:, :-1].reshape(B * H, nx), uss.reshape(B * H, nu)))
        ok = torch.ones(B, dtype=torch.bool, device=device)
        dv1 = torch.zeros(B, dtype=dtype, device=device)
        dv2 = torch.zeros(B, dtype=dtype, device=device)
        ks = [None] * H
        Ks = [None] * H
        for t in range(H - 1, -1, -1):
            x_k, u_k = xss[:, t], uss[:, t]
            if rr:
                A_k, B_k = _jacobians(f_replay, x_k, u_k, zss[:, t])
            else:
                A_k, B_k = _jacobians(f, x_k, u_k)
            with torch.no_grad():
                # fused quadratic expansion: with F = [A B] the three Q-blocks
                # come from ONE congruence FᵀVF and both gradient rows from
                # ONE FᵀVx
                F = torch.cat([A_k, B_k], dim=2)                # (B, nx, nx+nu)
                FtV = torch.einsum("bji,bj->bi", F, Vx)
                G = F.transpose(-1, -2) @ Vxx @ F
                Qx = cx[:, t] + FtV[:, :nx]
                Qu = cu[:, t] + FtV[:, nx:]
                Qxx = cxx[:, t] + G[:, :nx, :nx]
                Quu = cuu[:, t] + G[:, nx:, nx:]
                Qux = cux[:, t] + G[:, nx:, :nx]
                Quu = 0.5 * (Quu + Quu.transpose(-1, -2))
                Quu_reg = Quu + mus[:, None, None] * eye[None]
                Quu_inv, ok_k = _pd_inverse(Quu_reg)
                # gains + value recursion through stacked [k K] = -Quu⁻¹ [Qu Qux]
                W = torch.cat([Qu[:, :, None], Qux], dim=2)     # (B, nu, 1+nx)
                kK = -(Quu_inv @ W)
                k = kK[:, :, 0]
                K = kK[:, :, 1:]
                T1 = kK.transpose(-1, -2) @ W                    # kKᵀ[Qu Qux]
                T2 = kK.transpose(-1, -2) @ (Quu @ kK)
                Vx = Qx + T2[:, 1:, 0] + T1[:, 1:, 0] + T1[:, 0, 1:]
                Vxx = Qxx + T2[:, 1:, 1:] + T1[:, 1:, 1:] \
                    + T1[:, 1:, 1:].transpose(-1, -2)
                Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
                # expected cost change at alpha=1: Σ k·Qu + ½ k·Quu·k (the
                # iLQG model decrease), used to detect converged members
                dv1_k = torch.einsum("bi,bi->b", k, Qu)
                dv2_k = torch.einsum("bi,bij,bj->b", k, Quu, k)
                # finite-ness on (B,) scalars: dv1/dv2 only touch k, so the
                # sum over [k K] folds a NaN confined to K into one scalar
                # per member too
                kK_sum = kK.sum(dim=(1, 2))
                ok_k = (ok_k & torch.isfinite(dv1_k) & torch.isfinite(dv2_k)
                        & torch.isfinite(kK_sum))
                ok = ok & ok_k
                dv1 = dv1 + dv1_k
                dv2 = dv2 + dv2_k
                ks[t], Ks[t] = k, K
        expected = -(dv1 + 0.5 * dv2)   # positive when alpha=1 should improve
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok, expected

    alphas = [1.1 ** (-float(k) ** 2) for k in range(line_search_steps)]

    # cost is a sum over H stage terms, so its rounding scale is
    # ~sqrt(H)·eps·(1+|cost|); 8x headroom keeps the gate robust to the
    # model-decrease estimate itself being noisy at that scale
    conv_tol = float(8.0 * np.sqrt(H) * torch.finfo(dtype).eps)

    xss, _, zss = rollout(x0s, us0)
    uss = us0
    cost_prev = total_cost(xss, uss)
    mus = torch.full((B,), mu_init, dtype=dtype, device=device)
    for _ in range(n_iters):
        ks, Ks, ok, expected = backward(xss, uss, zss, mus)
        with torch.no_grad():
            # a member whose model-predicted decrease at alpha=1 is at
            # rounding scale is converged: no alpha can STRICTLY improve its
            # cost, so without this it would force the batch vote through
            # every alpha while changing nothing. Only members whose
            # regularizer sits at/near its floor qualify (a large mu shrinks
            # k and hence the predicted decrease).
            converged = ok & (expected >= 0) & (
                expected <= conv_tol * (1.0 + cost_prev.abs())
            ) & (mus <= 10 * mu_init)

            found = converged
            bx, bu, bz, bc = xss, uss, zss, cost_prev
            for alpha in alphas:
                if bool(found.all()):
                    break
                xs2, us2, zs2 = rollout(x0s, uss, ks, Ks, xss, alpha)
                c2 = total_cost(xs2, us2)
                better = (c2 < cost_prev) & ok & torch.isfinite(c2) & ~found
                sel = better[:, None, None]
                bx = torch.where(sel, xs2, bx)
                bu = torch.where(sel, us2, bu)
                if rr:
                    bz = torch.where(sel, zs2, bz)
                bc = torch.where(better, c2, bc)
                found = found | better
            xss, uss, zss, cost_prev = bx, bu, bz, bc
            mus = torch.where(found, (mus / 2).clamp_min(1e-8), mus * 10)

    return ILQRResult(us=uss, xs=xss, cost=cost_prev, n_iters=n_iters)
