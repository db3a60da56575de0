"""iLQR trajectory optimizer over the differentiable contact dynamics
(counterpart of ``moby_tpu/mpc/ilqr.py``: `ilqr` and `ilqr_batched`).

The contact-MPC outer loop: iterative LQR with step Jacobians obtained by
differentiating through `mpc.diffstep` (contact LCP included, via the IFT
autograd Functions of `solvers.difflcp`), a Riccati backward recursion with
Levenberg-style regularization, and a backtracking forward line search.

The batch of scenarios is the leading dimension of every array, and every
function handed in works on the whole batch:

    f(x (B, nx), u (B, nu)) -> x' (B, nx)
    cost(x (B, nx), u (B, nu)) -> (B,)        cost_final(x (B, nx)) -> (B,)

Members are independent of each other, which is what the Jacobians rely on
(see `_jacobians` and `jacfwd`). Loops are Python loops; the line search
asks the device once per step size whether every member has accepted.
`ilqr` optimizes one scenario through the same batched functions (batch 1,
or one member per step size in the parallel line search).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..solvers.lcp import gj_invert_pd


class ILQRResult(NamedTuple):
    us: torch.Tensor       # (B, H, nu) optimized controls ((H, nu) from `ilqr`)
    xs: torch.Tensor       # (B, H+1, nx) optimized trajectory ((H+1, nx))
    cost: torch.Tensor     # (B,) final cost (a scalar from `ilqr`)
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


def jacfwd(fn: Callable, primals, argnums, *extra):
    """Forward-mode Jacobians of a batched function whose members are
    independent: fn(*primals, *extra) -> one (B, m) tensor or a tuple of
    them, primals (B, n_j). Returns (outputs, jacs) with jacs[k][a] the
    (B, m_k, n_j) Jacobian of output k in primals[argnums[a]].

    The batch is replicated once per input direction (D = Σ n_j members),
    every replica carries one basis tangent as a `torch.autograd.forward_ad`
    dual tensor, and fn runs ONCE: one graph of launches for all columns,
    with no data-dependent control flow asked of `torch.func`. An output
    that no tangent reaches gets zero columns."""
    B = primals[0].shape[0]
    sizes = [primals[a].shape[1] for a in argnums]
    D = sum(sizes)

    def rep(t):
        return t.unsqueeze(0).expand((D,) + t.shape).reshape(
            (D * B,) + t.shape[1:])

    with torch.no_grad(), fwAD.dual_level():
        args = [rep(p.detach()) for p in primals]
        off = 0
        for a, n in zip(argnums, sizes):
            p = primals[a]
            tangent = p.new_zeros((D, B, n))
            tangent[off: off + n] = torch.eye(
                n, dtype=p.dtype, device=p.device)[:, None, :]
            args[a] = fwAD.make_dual(args[a], tangent.reshape(D * B, n))
            off += n
        out = fn(*args, *(rep(e.detach()) for e in extra))
        single = isinstance(out, torch.Tensor)
        outs, jacs = [], []
        for o in ((out,) if single else out):
            primal, tangent = fwAD.unpack_dual(o)
            m = primal.shape[1]
            outs.append(primal[:B].clone())
            if tangent is None:
                tangent = primal.new_zeros((D * B, m))
            J = tangent.reshape(D, B, m).permute(1, 2, 0)         # (B, m, D)
            jacs.append(list(torch.split(J, sizes, dim=2)))
    if single:
        return outs[0], jacs[0]
    return tuple(outs), jacs


def _jacobians_fwd(step: Callable, x, u, *extra):
    """(A, B) of x' = step(x, u, *extra) by forward mode (`jacfwd`): (nx+nu)·B
    replicas, one forward pass, no backward pass."""
    _, (A, Bm) = jacfwd(step, (x, u), (0, 1), *extra)
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


def _riccati_step(Vx, Vxx, A_k, B_k, cx, cu, cxx, cuu, cux, mus,
                  riccati_bf16=False):
    """One step of the Riccati recursion for a batch: the Q expansion of the
    value (Vx, Vxx) through (A_k, B_k), the gains k, K from the regularized
    Quu, the value one step earlier and the model decrease. -> (Vx, Vxx,
    ok, dv1, dv2, k, K).

    Fused quadratic expansion: with F = [A B] the three Q-blocks come from
    ONE congruence FᵀVF and both gradient rows from ONE FᵀVx. With
    riccati_bf16 the congruence takes F and Vxx rounded to bfloat16 and
    multiplies in the working dtype (JAX's preferred_element_type): the
    products are not rounded. The recursion feeds a line-searched descent
    direction, so reduced precision costs at most extra line-search or µ
    retries."""
    nx, nu = A_k.shape[1], B_k.shape[2]
    eye = torch.eye(nu, dtype=A_k.dtype, device=A_k.device)
    F = torch.cat([A_k, B_k], dim=2)                # (B, nx, nx+nu)
    FtV = torch.einsum("bji,bj->bi", F, Vx)
    if riccati_bf16:
        F_q = F.to(torch.bfloat16).to(F.dtype)
        V_q = Vxx.to(torch.bfloat16).to(F.dtype)
    else:
        F_q, V_q = F, Vxx
    G = F_q.transpose(-1, -2) @ V_q @ F_q
    Qx = cx + FtV[:, :nx]
    Qu = cu + FtV[:, nx:]
    Qxx = cxx + G[:, :nx, :nx]
    Quu = cuu + G[:, nx:, nx:]
    Qux = cux + G[:, nx:, :nx]
    Quu = 0.5 * (Quu + Quu.transpose(-1, -2))
    Quu_reg = Quu + mus[:, None, None] * eye[None]
    # PD check + inverse in one elimination; a failed step poisons `ok` and
    # the iteration retries at a higher mu
    Quu_inv, ok_k = _pd_inverse(Quu_reg)
    # gains + value recursion through stacked [k K] = -Quu⁻¹ [Qu Qux]
    W = torch.cat([Qu[:, :, None], Qux], dim=2)     # (B, nu, 1+nx)
    kK = -(Quu_inv @ W)
    k = kK[:, :, 0]
    K = kK[:, :, 1:]
    T1 = kK.transpose(-1, -2) @ W                    # kKᵀ[Qu Qux]
    T2 = kK.transpose(-1, -2) @ (Quu @ kK)
    Vx = Qx + T2[:, 1:, 0] + T1[:, 1:, 0] + T1[:, 0, 1:]
    Vxx = Qxx + T2[:, 1:, 1:] + T1[:, 1:, 1:] + T1[:, 1:, 1:].transpose(-1, -2)
    Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
    # expected cost change at alpha=1: Σ k·Qu + ½ k·Quu·k (the iLQG model
    # decrease), used to detect converged members
    dv1 = torch.einsum("bi,bi->b", k, Qu)
    dv2 = torch.einsum("bi,bij,bj->b", k, Quu, k)
    # finite-ness on (B,) scalars: dv1/dv2 only touch k, so the sum over
    # [k K] folds a NaN confined to K into one scalar per member too
    ok_k = (ok_k & torch.isfinite(dv1) & torch.isfinite(dv2)
            & torch.isfinite(kK.sum(dim=(1, 2))))
    return Vx, Vxx, ok_k, dv1, dv2, k, K


def _alphas(line_search_steps):
    return [1.1 ** (-float(k) ** 2) for k in range(line_search_steps)]


def _conv_tol(H, dtype):
    # cost is a sum over H stage terms, so its rounding scale is
    # ~sqrt(H)·eps·(1+|cost|); 8x headroom keeps the gate robust to the
    # model-decrease estimate itself being noisy at that scale
    return float(8.0 * np.sqrt(H) * torch.finfo(dtype).eps)


def ilqr(
    f: Callable,
    cost: Callable,
    cost_final: Callable,
    x0: torch.Tensor,
    us0: torch.Tensor,
    n_iters: int = 10,
    mu_init: float = 1e-6,
    line_search_steps: int = 8,
    parallel_line_search: bool = True,
) -> ILQRResult:
    """Minimize Σ cost(x, u) + cost_final(x_H) subject to x' = f(x, u) for one
    scenario: x0 (nx,), us0 (H, nu). f, cost and cost_final take batches
    (see the module docstring). Returns us (H, nu), xs (H+1, nx) and a scalar
    cost.

    Each iteration: a backward pass that linearizes f at every step of the
    trajectory (`_jacobians` of the full differentiable step, batch 1), the
    convergence rule, the line search over the step sizes 1.1^(-k²) that
    accepts the first (largest) step size improving the cost, and the µ
    update. `parallel_line_search` evaluates every step size in one rollout
    of one member per step size (sequential depth H instead of steps·H);
    False walks them one after another and stops at the first that
    improves. Both accept the same step."""
    H, nu = us0.shape
    nx = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    alphas = _alphas(line_search_steps)
    conv_tol = _conv_tol(H, dtype)

    def total_cost(xss, uss):
        N = xss.shape[0]
        stage = cost(xss[:, :-1].reshape(N * H, nx), uss.reshape(N * H, nu))
        return stage.reshape(N, H).sum(dim=1) + cost_final(xss[:, -1])

    def forward(xs, us, ks, Ks, alpha):
        """Controller rollouts u = u_ref + alpha·k + K (x - x_ref) from xs[0],
        one member per entry of alpha (N,) -> (xss (N, H+1, nx), uss)."""
        N = alpha.shape[0]
        x = xs[0].expand(N, nx)
        xs_, us_ = [x], []
        for t in range(H):
            u = us[t] + alpha[:, None] * ks[t] + (Ks[t] @ (x - xs[t]).T).T
            x = f(x, u)
            xs_.append(x)
            us_.append(u)
        return torch.stack(xs_, dim=1), torch.stack(us_, dim=1)

    def backward(xs, us, mu):
        Vx, Vxx = _final_derivatives(cost_final, xs[-1:])
        cx, cu, cxx, cuu, cux = _cost_derivatives(cost, xs[:-1], us)
        mus = mu.reshape(1)
        ok = torch.ones(1, dtype=torch.bool, device=device)
        dv1 = torch.zeros(1, dtype=dtype, device=device)
        dv2 = torch.zeros(1, dtype=dtype, device=device)
        ks, Ks = [None] * H, [None] * H
        for t in range(H - 1, -1, -1):
            A_k, B_k = _jacobians(f, xs[t:t + 1], us[t:t + 1])
            with torch.no_grad():
                Vx, Vxx, ok_k, dv1_k, dv2_k, k, K = _riccati_step(
                    Vx, Vxx, A_k, B_k, cx[t:t + 1], cu[t:t + 1], cxx[t:t + 1],
                    cuu[t:t + 1], cux[t:t + 1], mus)
                ok, dv1, dv2 = ok & ok_k, dv1 + dv1_k, dv2 + dv2_k
                ks[t], Ks[t] = k[0], K[0]
        return torch.stack(ks), torch.stack(Ks), ok[0], -(dv1 + 0.5 * dv2)[0]

    with torch.no_grad():
        xs = [x0[None]]
        for t in range(H):
            xs.append(f(xs[-1], us0[t:t + 1]))
        xs, us = torch.cat(xs, dim=0), us0
        cost_prev = total_cost(xs[None], us[None])[0]
    mu = torch.tensor(mu_init, dtype=dtype, device=device)
    for _ in range(n_iters):
        ks, Ks, ok, expected = backward(xs, us, mu)
        with torch.no_grad():
            # converged: the model-predicted decrease at alpha=1 is at
            # rounding scale (and mu near its floor) — keep the trajectory,
            # count the iteration as accepted
            converged = ok & (expected >= 0) & (
                expected <= conv_tol * (1.0 + cost_prev.abs())
            ) & (mu <= 10 * mu_init)
            if parallel_line_search:
                a = torch.tensor(alphas, dtype=dtype, device=device)
                xs_all, us_all = forward(xs, us, ks, Ks, a)
                c_all = total_cost(xs_all, us_all)
                # a failed backward pass (non-PD Quu at the current mu)
                # rejects the whole update: mu escalates below
                better = (c_all < cost_prev) & ok & torch.isfinite(c_all) & ~converged
                has_alpha = bool(better.any())
                if has_alpha:
                    sel = int(torch.argmax(better.to(torch.int8)))
                    xs, us, cost_prev = xs_all[sel], us_all[sel], c_all[sel]
                improved = has_alpha or bool(converged)
            else:
                improved = bool(converged)
                if not improved and bool(ok):
                    for alpha in alphas:
                        a = torch.tensor([alpha], dtype=dtype, device=device)
                        xs2, us2 = forward(xs, us, ks, Ks, a)
                        c2 = total_cost(xs2, us2)[0]
                        if bool(torch.isfinite(c2) & (c2 < cost_prev)):
                            xs, us, cost_prev = xs2[0], us2[0], c2
                            improved = True
                            break
            mu = (mu / 2).clamp_min(1e-8) if improved else mu * 10
    return ILQRResult(us=us, xs=xs, cost=cost_prev, n_iters=n_iters)


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
    hoist_linearization: bool = False,
    riccati_bf16: bool = False,
    linearize_fwd: bool = False,
    hoist_chunks: int = 1,
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

    hoist_linearization: compute all H step Jacobians before the Riccati
    recursion, in `hoist_chunks` calls over the flattened (B·T) batch of
    chunks of T whole time steps, instead of one call per step inside it:
    some H/hoist_chunks times fewer, larger launches. Values do not depend
    on the chunking.

    linearize_fwd (needs record/replay, whose replay step f_replay is
    differentiable in forward mode): step Jacobians by forward mode
    (`jacfwd` through f_replay, no backward pass), or by f_replay.jac
    (`contact_mpc`'s block-sparse linearizer) when it is set.

    riccati_bf16: see `_riccati_step`.
    """
    B, nx = x0s.shape
    if us0.dim() == 2:
        us0 = us0[None].expand((B,) + tuple(us0.shape))
    us0 = us0.contiguous()
    H, nu = us0.shape[1:]
    dtype, device = x0s.dtype, x0s.device
    rr = f_record is not None and f_replay is not None
    if linearize_fwd and not rr:
        raise ValueError(
            "linearize_fwd needs record/replay; the live pivoting solve has no "
            "forward-mode rule")

    if rr and linearize_fwd and getattr(f_replay, "jac", None) is not None:
        linearize = f_replay.jac
    elif rr and linearize_fwd:
        def linearize(x, u, z):
            return _jacobians_fwd(f_replay, x, u, z)
    elif rr:
        def linearize(x, u, z):
            return _jacobians(f_replay, x, u, z)
    else:
        def linearize(x, u, z):
            return _jacobians(f, x, u)

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

    def hoisted(xss, uss, zss):
        """Every step's (A, B), (B, H, nx, nx) and (B, H, nx, nu), in
        `hoist_chunks` calls of whole time steps."""
        bounds = np.linspace(0, H, max(1, min(hoist_chunks, H)) + 1).round()
        As, Bs = [], []
        for t0, t1 in zip(bounds[:-1].astype(int), bounds[1:].astype(int)):
            T = t1 - t0
            A_f, B_f = linearize(
                xss[:, t0:t1].reshape(B * T, nx), uss[:, t0:t1].reshape(B * T, nu),
                None if zss is None else zss[:, t0:t1].reshape(B * T, -1))
            As.append(A_f.reshape(B, T, nx, nx))
            Bs.append(B_f.reshape(B, T, nx, nu))
        return torch.cat(As, dim=1), torch.cat(Bs, dim=1)

    def backward(xss, uss, zss, mus):
        Vx, Vxx = _final_derivatives(cost_final, xss[:, -1])
        # the stage cost's derivatives at all H steps in one batched call
        cx, cu, cxx, cuu, cux = (
            d.reshape((B, H) + d.shape[1:]) for d in _cost_derivatives(
                cost, xss[:, :-1].reshape(B * H, nx), uss.reshape(B * H, nu)))
        if hoist_linearization:
            A_h, B_h = hoisted(xss, uss, zss)
        ok = torch.ones(B, dtype=torch.bool, device=device)
        dv1 = torch.zeros(B, dtype=dtype, device=device)
        dv2 = torch.zeros(B, dtype=dtype, device=device)
        ks = [None] * H
        Ks = [None] * H
        for t in range(H - 1, -1, -1):
            if hoist_linearization:
                A_k, B_k = A_h[:, t], B_h[:, t]
            else:
                A_k, B_k = linearize(xss[:, t], uss[:, t],
                                     None if zss is None else zss[:, t])
            with torch.no_grad():
                Vx, Vxx, ok_k, dv1_k, dv2_k, k, K = _riccati_step(
                    Vx, Vxx, A_k, B_k, cx[:, t], cu[:, t], cxx[:, t],
                    cuu[:, t], cux[:, t], mus, riccati_bf16)
                ok = ok & ok_k
                dv1 = dv1 + dv1_k
                dv2 = dv2 + dv2_k
                ks[t], Ks[t] = k, K
        expected = -(dv1 + 0.5 * dv2)   # positive when alpha=1 should improve
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok, expected

    alphas = _alphas(line_search_steps)
    conv_tol = _conv_tol(H, dtype)

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
