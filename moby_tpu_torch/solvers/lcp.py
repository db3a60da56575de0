"""Batched, fixed-shape LCP solvers (counterpart of ``moby_tpu/solvers/lcp.py``).

Finds z >= 0 with w = M z + q >= 0 and z'w = 0, for a batch: M (B, n, n),
q (B, n), mask (B, n) bool; every solver returns (z (B, n), ok (B,)).

* :func:`lcp_fast` — principal pivoting method ("PPM I", reference
  src/LCP.cpp:41-196) for monotone LCPs, warm-startable.
* :func:`lcp_lemke` — Lemke's algorithm with covering vector on the negative
  components (reference src/LCP.cpp:545-1003); the robust fallback.
* :func:`lcp_fast_regularized` / :func:`lcp_lemke_regularized` — Tikhonov
  sweeps λ = 10^k with solution verification (src/LCP.cpp:212-487).
* :func:`lcp_bpp` — block principal pivoting (Júdice–Pires).
* :func:`solve_lcp` / :func:`solve_lcp_fast_lemke` — the production cascades.

A problem of true size m lives in an n-slot padded system; masked-out slots
carry M_ii = 1, q_i = +1, which keeps them inert in every pivot rule.

Loops with data-dependent trip counts. The JAX package runs each solver as a
`lax.while_loop` under `vmap`: the body runs while any member's condition
holds and finished members are frozen by select. Here the same thing is
written out: a Python loop of masked batched iterations,
``torch.where(active, new, old)`` per carried field, left when no member is
active (one host synchronisation per iteration) or at the cap. A member whose
`skip` flag is set is done at entry.

Routing. A CUDA tensor takes the accelerated cascade (`_solve_accel`: batched
BPP, then the hand-written PPM kernel of `hopper_lcp`, then the plain
cascade); a CPU tensor takes the plain cascade. ``cascade="accel"`` on a CPU
tensor forces the accelerated cascade with the kernel's plain version in its
place (tests). The ``_plain`` cascades are the JAX package's ``_xla`` ones.
Masked sub-solves use Gauss–Jordan on float32 and an LU solve on float64
(`_use_gj`; `math.linalg.solve_ex`, LAPACK's LU on the CPU); `gj_invert_masked` and `gj_invert_pd` are the explicit
inverses of the same elimination, for the IFT pullback of `difflcp` and the
Riccati sweep of `mpc.ilqr`. The JAX package's opt-in working-set compaction
(`bpp_compact_cap`, off by default) is not carried: its default is ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as cfg
from ..math import linalg

# static panel width of the blocked elimination
_GJ_BLOCK = 8
# masked systems at least this large route through the blocked elimination
# (0 disables)
_GJ_BLOCK_MIN_N = 32


def _eps(dtype):
    return cfg.eps(dtype)


def _tiny(dtype):
    return torch.finfo(dtype).tiny * 1e8


def _bsel(cond, a, b):
    """Per-member select: cond (B,) against a, b (B, ...)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _no_skip(skip, q):
    if skip is None:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    return skip


def _masked_norm_inf(M, mask):
    """inf-norm (max abs row sum) over the active submatrix, (B,)."""
    outer = mask[:, :, None] & mask[:, None, :]
    rows = torch.where(outer, M, 0.0).abs().sum(dim=2)
    return torch.where(mask, rows, 0.0).amax(dim=1)


def pad_lcp(M, q, mask):
    """Make padded slots inert: M_ii = 1 on the diagonal, q_i = +1."""
    outer = mask[:, :, None] & mask[:, None, :]
    Mp = torch.where(outer, M, 0.0) + torch.diag_embed((~mask).to(M.dtype))
    qp = torch.where(mask, q, 1.0)
    return Mp, qp


def gj_solve_masked(A, b, active):
    """Solve the `active`-masked system A x = b by unpivoted Gauss–Jordan.

    A must already be the masked system (identity rows/cols on inactive
    slots). The masked systems of the principal-pivoting sub-solves are
    principal submatrices of the QP KKT-LCP matrix, whose symmetric part is
    PSD — elimination without pivoting is then Cholesky-grade stable, and a
    (near-)singular submatrix surfaces as a vanishing pivot: that step's row
    is zeroed (the dependent coordinate stays zero) and `ok` reports it.

    A fixed-trip loop of rank-1 updates over the whole batch; works in place
    on private copies of A and b. Returns (x, ok).
    """
    n = b.shape[-1]
    tiny = _tiny(A.dtype)
    A = A.clone()
    b = b.clone()
    minpiv = torch.full(b.shape[:-1], torch.inf, dtype=A.dtype, device=A.device)
    for k in range(n):
        prow = A[..., k, :]
        piv = prow[..., k]
        apiv = piv.abs()
        minpiv = torch.minimum(minpiv, apiv)
        good = apiv > tiny
        inv = torch.where(good, 1.0 / torch.where(good, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        pb = b[..., k] * inv
        factor = A[..., :, k].clone()
        factor[..., k] = 0.0
        A -= factor[..., None] * prow[..., None, :]
        b -= factor * pb[..., None]
        A[..., k, :] = prow
        b[..., k] = pb
    # inactive slots have unit pivots; a tiny pivot on an active row means the
    # masked system was singular
    ok = (minpiv > tiny) & torch.isfinite(b).all(dim=-1)
    return b, ok


def _gj_invert(A, signed: bool):
    """Unpivoted Gauss–Jordan inverse of (…, n, n) systems, carrying the
    identity through the row operations; a vanishing pivot zeroes its row,
    as in `gj_solve_masked`. Returns (Ainv, minpiv): the least |pivot|, or
    the least signed pivot with `signed`."""
    n = A.shape[-1]
    tiny = _tiny(A.dtype)
    A = A.clone()
    E = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    minpiv = torch.full(A.shape[:-2], torch.inf, dtype=A.dtype, device=A.device)
    # under reverse-mode differentiation (the articulated inverse inertia of
    # the MPC step) the pivot rows are copied: the in-place updates below
    # would overwrite views that the products save for the backward pass
    copy_rows = A.requires_grad and torch.is_grad_enabled()
    for k in range(n):
        prow = A[..., k, :]
        erow = E[..., k, :]
        if copy_rows:
            prow, erow = prow.clone(), erow.clone()
        piv = prow[..., k]
        minpiv = torch.minimum(minpiv, piv if signed else piv.abs())
        good = piv.abs() > tiny
        inv = torch.where(good, 1.0 / torch.where(good, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        erow = erow * inv[..., None]
        factor = A[..., :, k].clone()
        factor[..., k] = 0.0
        A -= factor[..., None] * prow[..., None, :]
        E -= factor[..., None] * erow[..., None, :]
        A[..., k, :] = prow
        E[..., k, :] = erow
    return E, minpiv


def gj_solve_masked_blocked(A, b, active, bs: int = _GJ_BLOCK):
    """Blocked (panel) variant of `gj_solve_masked`: identical elimination
    order, but bs pivots are processed per sweep — the within-panel transform
    E comes from a tiny unrolled GJ and the trailing update is two matmuls,
    so n sequential full-matrix rank-1 passes become n/bs panel sweeps.

    Equivalent to the unblocked elimination in exact arithmetic (Schur
    identity); vanishing-pivot rows are skipped inside the panel exactly as
    the unblocked route skips them, and `ok` reports the same min-pivot
    criterion. Returns (x, ok)."""
    n = b.shape[-1]
    tiny = _tiny(A.dtype)
    A = A.clone()
    b = b.clone()
    minpiv = torch.full(b.shape[:-1], torch.inf, dtype=A.dtype, device=A.device)
    for s in range(0, n, bs):
        e = min(s + bs, n)
        E, mp = _gj_invert(A[..., s:e, s:e], signed=False)
        minpiv = torch.minimum(minpiv, mp)
        R = E @ A[..., s:e, :]                      # transformed panel rows
        bJ = (E @ b[..., s:e, None])[..., 0]
        C = A[..., :, s:e].clone()
        # block rows are replaced, not updated: zero their factor
        C[..., s:e, :] = 0.0
        A -= C @ R
        b -= (C @ bJ[..., None])[..., 0]
        A[..., s:e, :] = R
        b[..., s:e] = bJ
    ok = (minpiv > tiny) & torch.isfinite(b).all(dim=-1)
    return b, ok


def gj_invert_masked(A, active):
    """Invert the `active`-masked system (identity rows/cols on inactive
    slots) by the same unpivoted Gauss–Jordan as `gj_solve_masked`.

    Costs about two `gj_solve_masked` and serves many right-hand sides: the
    IFT pullback of `difflcp`, where every output row of a step Jacobian is
    one matvec against the same principal inverse. Returns (Ainv, ok)."""
    E, minpiv = _gj_invert(A, signed=False)
    ok = (minpiv > _tiny(A.dtype)) & torch.isfinite(E).all(dim=-1).all(dim=-1)
    return E, ok


def gj_invert_pd(A):
    """Batched inverse of symmetric matrices by unpivoted Gauss–Jordan with
    a positive-definiteness check: a symmetric matrix is PD iff every
    natural-order elimination pivot is positive (the Cholesky criterion).
    The float32 route of the Riccati sweep's Quu solve. Returns
    (Ainv, pd_ok)."""
    E, minpiv = _gj_invert(A, signed=True)
    ok = (minpiv > _tiny(A.dtype)) & torch.isfinite(E).all(dim=-1).all(dim=-1)
    return E, ok


def _use_gj(dtype):
    """Route masked sub-solves through the Gauss–Jordan on float32 (the
    card's execution dtype); keep LAPACK LU on float64 (regression mode)."""
    return dtype == torch.float32


def solve_principal(M, rhs, nonbas):
    """Solve the principal subsystem M[nb, nb] x_nb = rhs_nb; zero elsewhere.

    The shared sub-solve of every pivoting method (the reference's
    `solve_fast`): builds the masked system (identity on inactive slots) and
    routes it to Gauss–Jordan on float32 or LAPACK on float64. Returns
    (x, ok)."""
    n = rhs.shape[-1]
    outer = nonbas[:, :, None] & nonbas[:, None, :]
    A = torch.where(outer, M, 0.0) + torch.diag_embed((~nonbas).to(M.dtype))
    b = torch.where(nonbas, rhs, 0.0)
    if _use_gj(M.dtype):
        if _GJ_BLOCK_MIN_N and n >= _GJ_BLOCK_MIN_N:
            x, ok = gj_solve_masked_blocked(A, b, nonbas)
        else:
            x, ok = gj_solve_masked(A, b, nonbas)
    else:
        # a singular system gives non-finite values, which `ok` reports: in
        # the cases the JAX package's LAPACK solve does (`linalg.solve_ex`)
        x = linalg.solve_ex(A, b[..., None])[..., 0]
        ok = torch.isfinite(x).all(dim=-1)
    return torch.where(nonbas, x, 0.0), ok


def _first_min_index(v, valid):
    """Index of the minimum of v over `valid` slots (first on ties), (B,).

    The reference breaks ties randomly (`rand_min`, src/LCP.cpp:199); the
    deterministic first minimum coincides whenever the minimum is unique."""
    vm = torch.where(valid, v, torch.inf)
    return torch.argmin(vm, dim=-1)


def _at(v, idx):
    """v[b, idx[b]] for v (B, n), idx (B,)."""
    return torch.gather(v, 1, idx[:, None])[:, 0]


def _onehot(idx, n):
    """(B, n) bool one-hot rows."""
    return torch.arange(n, device=idx.device)[None, :] == idx[:, None]


class LCPStats(NamedTuple):
    """Per-solve effort counters (the reference's LCP pivot counters,
    include/Moby/LCP.h:30)."""

    pivots: torch.Tensor    # (B,) int32: pivot/iteration count of the solve
    fallback: torch.Tensor  # (B,) bool: did the solve leave the primary stage


def _ztol(M, mask, zero_tol):
    """Auto zero tolerance m·‖M‖∞·eps unless `zero_tol` (float or (B,)) >= 0."""
    dtype = M.dtype
    m_active = mask.sum(dim=-1)
    auto_tol = m_active.to(dtype) * _masked_norm_inf(M, mask) * _eps(dtype)
    zt = torch.as_tensor(zero_tol, dtype=dtype, device=M.device).expand_as(auto_tol)
    return torch.where(zt < 0.0, auto_tol, zt), m_active


def lcp_fast(M, q, mask, z0=None, zero_tol=-1.0, skip=None):
    """Principal pivoting (reference `LCP::lcp_fast`, src/LCP.cpp:41).

    Args:
      M, q: padded (B, n, n), (B, n) problems.
      mask: (B, n) bool, active slots.
      z0:   optional warm-start z (basis seeded from |z0| >= zero_tol).
      zero_tol: negative -> auto (m * ||M||_inf * eps), like the reference.

    Returns (z, ok).
    """
    B, n = q.shape
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    ztol, m_active = _ztol(M, mask, zero_tol)
    skip = _no_skip(skip, q)

    # initial basis
    cold_i = _first_min_index(q, mask)
    cold_trivial = _at(q, cold_i) > -ztol
    if z0 is None:
        trivial = cold_trivial
        nonbas0 = _onehot(cold_i, n) & mask & ~trivial[:, None]
    else:
        z0 = torch.where(mask, z0, 0.0)
        nonbas0 = (z0.abs() >= ztol[:, None]) & mask
        # if warm basis empty, behave like the cold start
        empty = ~nonbas0.any(dim=-1)
        trivial = empty & cold_trivial
        nonbas0 = _bsel(
            empty, _onehot(cold_i, n) & mask & ~trivial[:, None], nonbas0)

    max_piv = 2 * m_active
    use_gj = _use_gj(dtype)

    nonbas = nonbas0
    z = torch.zeros_like(q)
    done = trivial | skip
    failed = torch.zeros_like(done)
    pivots = torch.zeros(B, dtype=torch.int32, device=q.device)
    while True:
        active = ~done & ~failed & (pivots < max_piv)
        if not bool(active.any()):
            break
        z_n, solvable = solve_principal(M, -q, nonbas)
        bas = mask & ~nonbas
        w = torch.where(bas, (M @ z_n[..., None])[..., 0] + q, 0.0)

        any_bas = bas.any(dim=-1)
        minw_i = _first_min_index(w, bas)
        minw = torch.where(any_bas, _at(w, minw_i), torch.inf)
        any_nb = nonbas.any(dim=-1)
        minz_i = _first_min_index(z_n, nonbas)
        minz = torch.where(any_nb, _at(z_n, minz_i), torch.inf)

        w_ok = ~any_bas | (minw > -ztol)
        z_neg = any_nb & (minz < -ztol)

        # case 1: w >= 0 everywhere
        #   z >= 0 too -> solved;  else move most-negative z out of nonbasic
        # case 2: some w < 0 -> move that index into nonbasic;
        #   and if some z < 0, move that index out of nonbasic
        move_out = _onehot(minz_i, n) & z_neg[:, None]
        move_in = _onehot(minw_i, n) & (~w_ok & any_bas)[:, None]
        solved = w_ok & ~z_neg
        nonbas_next = (nonbas | move_in) & ~move_out

        if use_gj:
            # the GJ sub-solve SKIPS vanishing pivots (dependent coordinates
            # stay zero), so a singular principal submatrix still yields a
            # usable iterate: keep pivoting instead of aborting (the caller
            # verifies before accepting; max_piv bounds cycling). Early-abort
            # survives on the float64 LAPACK route, whose singular solves
            # return non-finite.
            nb_new = _bsel(solved, nonbas, nonbas_next)
            z_new, done_new = z_n, solved
            failed_new = torch.zeros_like(failed)
        else:
            nb_new = _bsel(solved | ~solvable, nonbas, nonbas_next)
            z_new = _bsel(solvable, z_n, z)
            done_new = solved & solvable
            failed_new = ~solvable
        nonbas = _bsel(active, nb_new, nonbas)
        z = _bsel(active, z_new, z)
        done = torch.where(active, done_new, done)
        failed = torch.where(active, failed_new, failed)
        pivots = pivots + active.to(torch.int32)

    z = torch.where(mask & ~(trivial | skip)[:, None], z, 0.0)
    ok = (done | trivial) & ~skip
    return z, ok


def _verify(M, q, z, mask, check_tol):
    """Solution verification used by the regularized wrappers
    (reference src/LCP.cpp:239-260). check_tol is (B,)."""
    tol = check_tol[:, None]
    zm = torch.where(mask, z, 0.0)
    w = torch.where(mask, (M @ zm[..., None])[..., 0] + q, 0.0)
    z_ok = (zm >= -tol).all(dim=-1)
    w_ok = (w >= -tol).all(dim=-1)
    zw = zm * w
    # <= so the empty/trivial problem (z = w = 0, and check_tol = 0 when the
    # mask is empty) verifies
    c_ok = (zw >= -tol).all(dim=-1) & (torch.where(mask, zw, 0.0) <= tol).all(dim=-1)
    return z_ok & w_ok & c_ok


def _check_tol(Mp, mask, zero_tol=-1.0):
    """m·‖M‖∞·sqrt(eps) unless `zero_tol` > 0, (B,)."""
    dtype = Mp.dtype
    m_active = mask.sum(dim=-1).to(dtype)
    auto = m_active * _masked_norm_inf(Mp, mask) * (_eps(dtype) ** 0.5)
    zt = torch.as_tensor(zero_tol, dtype=dtype, device=Mp.device).expand_as(auto)
    return torch.where(zt > 0.0, zt, auto)


def _regularized(solver, M, q, mask, exps, zero_tol, skip):
    """Shared Tikhonov sweep: λ = 0, then 10^k for k in exps; the first
    verified solution of each member is kept. Members that are good (or
    skipped) are done at entry of the later attempts."""
    n = q.shape[-1]
    M, q = pad_lcp(M, q, mask)
    check_tol = _check_tol(M, mask, zero_tol)
    skip = _no_skip(skip, q)
    eye_m = torch.diag_embed(mask.to(M.dtype))

    z = torch.zeros_like(q)
    good = torch.zeros_like(skip)
    for lam in [0.0] + [10.0 ** e for e in exps]:
        todo = ~good & ~skip
        if not bool(todo.any()):
            break
        Mreg = M + lam * eye_m
        z2, ok = solver(Mreg, q, ~todo)
        good2 = ok & _verify(Mreg, q, z2, mask, check_tol)
        z = _bsel(todo & good2, z2, z)
        good = good | (todo & good2)
    return z, good


def lcp_fast_regularized(
    M, q, mask, z0=None, min_exp=-20, step_exp=4, max_exp=20, zero_tol=-1.0,
    skip=None,
):
    """Tikhonov-sweep wrapper around :func:`lcp_fast`
    (reference src/LCP.cpp:212-353): λ = 0, then λ = 10^k for
    k = min_exp, min_exp+step_exp, ... while k < max_exp, accepting the first
    verified solution."""
    return _regularized(
        lambda Mr, qr, sk: lcp_fast(Mr, qr, mask, z0=z0, zero_tol=zero_tol,
                                    skip=sk),
        M, q, mask, range(min_exp, max_exp, step_exp), zero_tol, skip,
    )


def lcp_lemke(M, q, mask, piv_tol=-1.0, zero_tol=-1.0, skip=None):
    """Lemke's algorithm (reference src/LCP.cpp:545-1003), cold-started.

    Variable ids: 0..n-1 -> z_i, n..2n-1 -> w_i, 2n -> artificial t.
    The artificial column is a covering vector with 1s on the initially
    negative components of q (reference src/LCP.cpp:779-790).
    """
    B, n = q.shape
    dtype, device = M.dtype, M.device
    M, q = pad_lcp(M, q, mask)
    m_active = mask.sum(dim=-1)
    t_var = 2 * n
    skip = _no_skip(skip, q)

    norminf = _masked_norm_inf(M, mask)
    mf = m_active.to(dtype)
    zt = torch.as_tensor(zero_tol, dtype=dtype, device=device).expand_as(mf)
    ztol = torch.where(zt > 0.0, zt, _eps(dtype) * norminf * mf)
    pt_ = torch.as_tensor(piv_tol, dtype=dtype, device=device).expand_as(mf)
    ptol = torch.where(pt_ > 0.0, pt_,
                       _eps(dtype) * mf * norminf.clamp_min(1.0))

    trivial = torch.where(mask, q, torch.inf).amin(dim=-1) > -ztol
    maxiter = torch.where(skip, 0, (50 * m_active).clamp_max(1000))

    # initial: basis = all w vars, Bl = -I, x = q
    arange = torch.arange(n, device=device)
    basvar = (arange + n)[None, :].expand(B, n).clone()
    Bl = (-torch.eye(n, dtype=dtype, device=device)).expand(B, n, n).clone()
    x0 = q

    # first pivot: artificial variable enters, most-negative x leaves
    lv0 = _first_min_index(x0, mask)
    tval = -_at(x0, lv0)
    u = ((x0 < 0.0) & mask).to(dtype)
    Be0 = -(Bl @ u[..., None])[..., 0]
    oh0 = _onehot(lv0, n)
    x = torch.where(oh0, tval[:, None], x0 + u * tval[:, None])
    Bl = torch.where(oh0[:, None, :], Be0[:, :, None], Bl)
    leaving = _at(basvar, lv0)
    basvar = torch.where(oh0, t_var, basvar)

    done = torch.zeros_like(skip)
    failed = torch.zeros_like(skip)
    pivots = torch.zeros(B, dtype=torch.int64, device=device)
    while True:
        active = ~done & ~failed & (pivots < maxiter)
        if not bool(active.any()):
            break
        # entering variable = complement of the leaving one
        lz = leaving < n  # a z var left -> w_leaving enters with column -e
        entering = torch.where(lz, n + leaving, leaving - n)
        col_i = (leaving - n).clamp(0, n - 1)
        Mcol = torch.gather(M, 2, col_i[:, None, None].expand(B, n, 1))[..., 0]
        Be = torch.where(lz[:, None], -_onehot(leaving, n).to(dtype), Mcol)
        d = linalg.solve_ex(Bl, Be[..., None])[..., 0]
        solvable = torch.isfinite(d).all(dim=-1)

        j = d > ptol[:, None]
        ray = ~j.any(dim=-1)

        # min-ratio test with the reference's tolerance shift
        ratio_sel = torch.where(j, (x + ztol[:, None]) / d, torch.inf)
        theta = ratio_sel.amin(dim=-1)
        cand = j & (torch.where(j, x / d, torch.inf) <= theta[:, None])

        # prefer the artificial variable if it can leave
        art_cand = cand & (basvar == t_var)
        any_art = art_cand.any(dim=-1)
        lv_art = torch.argmax(art_cand.to(torch.int8), dim=-1)
        lv_first = torch.argmax(cand.to(torch.int8), dim=-1)
        lv = torch.where(any_art, lv_art, lv_first)

        oh = _onehot(lv, n)
        ratio = _at(x, lv) / _at(d, lv)
        x_new = torch.where(oh, ratio[:, None], x - d * ratio[:, None])
        Bl_new = torch.where(oh[:, None, :], Be[:, :, None], Bl)
        new_leaving = _at(basvar, lv)
        basvar_new = torch.where(oh, entering[:, None], basvar)

        fail = ray | ~solvable
        upd = active & ~fail
        basvar = _bsel(upd, basvar_new, basvar)
        Bl = _bsel(upd, Bl_new, Bl)
        x = _bsel(upd, x_new, x)
        leaving = torch.where(upd, new_leaving, leaving)
        done = torch.where(active, (new_leaving == t_var) & ~fail, done)
        failed = torch.where(active, fail, failed)
        pivots = pivots + active.to(torch.int64)

    # scatter basic values into z (variable ids < n are z vars)
    is_z = basvar < n
    z = torch.zeros_like(q).scatter_add_(
        1, torch.where(is_z, basvar, n - 1), torch.where(is_z, x, 0.0))
    z = torch.where(mask & ~(trivial | skip)[:, None], z, 0.0)
    ok = (trivial | (done & ~failed)) & ~skip
    return z, ok


def lcp_lemke_regularized(
    M, q, mask, min_exp=-20, step_exp=1, max_exp=1, piv_tol=-1.0, zero_tol=-1.0,
    skip=None,
):
    """Tikhonov-sweep wrapper around :func:`lcp_lemke`
    (reference src/LCP.cpp:353-487)."""
    return _regularized(
        lambda Mr, qr, sk: lcp_lemke(Mr, qr, mask, piv_tol=piv_tol,
                                     zero_tol=zero_tol, skip=sk),
        M, q, mask, range(min_exp, max_exp, step_exp), zero_tol, skip,
    )


def lcp_bpp(M, q, mask, z0=None, zero_tol=-1.0, max_iters: int = 24,
            p_budget: int = 3, skip=None, with_pivots=False):
    """Block principal pivoting (Júdice–Pires) for the LCP.

    Same sub-problem solve as :func:`lcp_fast`, but every iteration swaps
    *all* violating indices between the basic and nonbasic sets at once:

        F ← (F \\ {i ∈ F : z_i < -tol}) ∪ {i ∉ F : w_i < -tol}

    For the monotone QP-derived LCPs of the impact handler this converges in
    a handful of iterations independent of problem size. The classic cycling
    safeguard applies: when the infeasibility count fails to strictly
    decrease for `p_budget` consecutive iterations, fall back to switching
    only the first (least index) violator — Murty's method, finite for
    P-matrices.

    Callers must verify the solution (`_verify`) before accepting; the
    production cascade falls back to the exact pivoting path on failure.
    """
    B, n = q.shape
    dtype, device = M.dtype, M.device
    M, q = pad_lcp(M, q, mask)
    ztol, _ = _ztol(M, mask, zero_tol)
    skip = _no_skip(skip, q)

    # initial F: warm-start support, else the q<0 set (one-shot for the
    # common resting-contact case where the whole active set pushes)
    if z0 is None:
        z0 = torch.zeros_like(q)
    z0 = torch.where(mask, z0, 0.0)
    warm = (z0.abs() >= ztol[:, None]) & mask
    cold = (q < -ztol[:, None]) & mask
    nonbas = _bsel(warm.any(dim=-1), warm, cold)
    trivial = ~nonbas.any(dim=-1)

    arange = torch.arange(n, device=device)
    use_gj = _use_gj(dtype)

    z = torch.zeros_like(q)
    done = trivial | skip
    failed = torch.zeros_like(done)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    ninf_best = torch.full((B,), n + 1, dtype=torch.int32, device=device)
    p = torch.full((B,), p_budget, dtype=torch.int32, device=device)
    while True:
        active = ~done & ~failed & (iters < max_iters)
        if not bool(active.any()):
            break
        z_n, solvable = solve_principal(M, -q, nonbas)
        bas = mask & ~nonbas
        w = torch.where(bas, (M @ z_n[..., None])[..., 0] + q, 0.0)

        H1 = nonbas & (z_n < -ztol[:, None])       # z-basic but negative -> leave
        H2 = bas & (w < -ztol[:, None])            # w negative -> enter
        ninf = (H1.sum(dim=-1) + H2.sum(dim=-1)).to(torch.int32)

        improved = ninf < ninf_best
        p_next = torch.where(improved, p_budget, p - 1)

        # full block swap while the safeguard budget holds; otherwise swap
        # only the first violating index (Murty's least-index rule)
        viol = H1 | H2
        first_i = _first_min_index(
            torch.where(viol, arange, n).to(dtype), viol)
        single = _onehot(first_i, n) & viol
        use_block = (p_next > 0)[:, None]
        H1e = torch.where(use_block, H1, single & H1)
        H2e = torch.where(use_block, H2, single & H2)
        nonbas_next = (nonbas & ~H1e) | H2e

        if use_gj:
            # pivot-skipping GJ sub-solves survive singular principal
            # submatrices (see lcp_fast): keep iterating instead of aborting.
            # Violated rows of the skipped coordinates re-enter via H1/H2;
            # _verify gates acceptance; max_iters bounds cycling.
            solved = ninf == 0
            keep = solved
            z_new = z_n
            failed_new = torch.zeros_like(failed)
        else:
            solved = (ninf == 0) & solvable
            keep = solved | ~solvable
            z_new = _bsel(solvable, z_n, z)
            failed_new = ~solvable
        nonbas = _bsel(active, _bsel(keep, nonbas, nonbas_next), nonbas)
        z = _bsel(active, z_new, z)
        done = torch.where(active, solved, done)
        failed = torch.where(active, failed_new, failed)
        iters = iters + active.to(torch.int32)
        ninf_best = torch.where(active & improved, ninf, ninf_best)
        p = torch.where(active, p_next.clamp_min(0), p)

    z = torch.where(mask & ~(trivial | skip)[:, None], z, 0.0)
    ok = (done | trivial) & ~skip
    if with_pivots:
        return z, ok, iters
    return z, ok


def _bpp_prepass(M, q, mask, z0, skip):
    """Verified BPP, shared first stage of every cascade."""
    Mp, qp = pad_lcp(M, q, mask)
    check_tol = _check_tol(Mp, mask)
    z_bp, ok_bp, piv_bp = lcp_bpp(M, q, mask, z0=z0, skip=skip,
                                  with_pivots=True)
    ok_bp = ok_bp & _verify(Mp, qp, z_bp, mask, check_tol)
    return Mp, qp, check_tol, z_bp, ok_bp, piv_bp


def _solve_accel(M, q, mask, z0, skip, plain_fallback):
    """The accelerated solve cascade:

    1. **Batched BPP** (`lcp_bpp`): a handful of lock-step iterations whose
       per-iteration work vectorizes across the whole batch.
    2. **Warm-started PPM kernel** (`hopper_lcp.ppm_lcp`), masked to the
       problems BPP failed to verify: each thread block runs exactly its own
       pivot count, so one hard problem does not lock-step the whole batch
       through an O(m) pivot chain; a problem that is already solved (or
       skipped) has an all-false mask and its block leaves at once.
    3. The given plain cascade (regularized Lemke etc.), skip-gated to
       whatever still failed.

    Stage 2 exists only when the problem fits one thread block's shared
    memory: that is decided here, statically, from n and the dtype
    (`hopper_lcp.fits`), never by catching a failed launch. Above the gate
    the cascade is stage 1 then stage 3.
    """
    from . import hopper_lcp

    skip = _no_skip(skip, q)
    Mp, qp, check_tol, z_bp, ok_bp, piv_bp = _bpp_prepass(M, q, mask, z0, skip)

    if hopper_lcp.fits(q.shape[-1], M.dtype):
        m_eff = mask & ~(skip | ok_bp)[:, None]
        z0_eff = z0 if z0 is None else torch.where(m_eff, z0, 0.0)
        z_pl, done_pl = hopper_lcp.ppm_lcp(M, q, m_eff, z0=z0_eff)
        ok_pl = (
            done_pl & _verify(Mp, qp, z_pl, m_eff, check_tol) & ~ok_bp & ~skip
            & m_eff.any(dim=-1)
        )
    else:
        z_pl = torch.zeros_like(q)
        ok_pl = torch.zeros_like(ok_bp)

    z_fb, ok_fb = plain_fallback(M, q, mask, z0, skip | ok_bp | ok_pl)
    z = _bsel(ok_bp, z_bp, _bsel(ok_pl, z_pl, z_fb))
    z = torch.where(mask & ~skip[:, None], z, 0.0)
    stats = LCPStats(pivots=piv_bp, fallback=(~ok_bp & ~skip))
    return z, (ok_bp | ok_pl | ok_fb) & ~skip, stats


def _route_accel(M, cascade):
    if cascade is None:
        return M.device.type == "cuda"
    if cascade not in ("accel", "plain"):
        raise ValueError(f"cascade must be 'accel', 'plain' or None, got {cascade!r}")
    return cascade == "accel"


def _check_device(t, device):
    if device is not None and t.device.type != cfg.resolve_device(device).type:
        raise ValueError(
            f"tensors live on '{t.device}' but device='{device}' was asked for")


def solve_lcp_fast_lemke(M, q, mask, z0=None, skip=None, with_stats=False,
                         cascade=None):
    """`lcp_fast` then `lcp_lemke_regularized` (the cascade used by the
    stabilization path, e.g. src/ConstraintStabilization.cpp:955), with the
    BPP prepass. On the card the solve runs the `_solve_accel` cascade."""
    if _route_accel(M, cascade):
        z, ok, stats = _solve_accel(M, q, mask, z0, skip, _solve_fast_lemke_plain)
    else:
        z, ok, stats = _solve_fast_lemke_plain(M, q, mask, z0, skip,
                                               with_stats=True)
    if with_stats:
        return z, ok, stats
    return z, ok


def _solve_fast_lemke_plain(M, q, mask, z0=None, skip=None, with_stats=False):
    skip = _no_skip(skip, q)
    Mp, qp, check_tol, z_bp, ok_bp, piv_bp = _bpp_prepass(M, q, mask, z0, skip)

    z, ok = lcp_fast(M, q, mask, z0=z0, skip=ok_bp | skip)
    ok = ok & _verify(Mp, qp, z, mask, check_tol)
    z2, ok2 = lcp_lemke_regularized(M, q, mask, skip=ok_bp | ok | skip)
    z_out = _bsel(ok_bp, z_bp, _bsel(ok, z, z2))
    if with_stats:
        stats = LCPStats(pivots=piv_bp, fallback=(~ok_bp & ~skip))
        return z_out, ok_bp | ok | ok2, stats
    return z_out, ok_bp | ok | ok2


def solve_lcp(M, q, mask, z0=None, skip=None, with_stats=False, cascade=None,
              device="cuda"):
    """Production path mirroring the impact handler's solver cascade
    (reference src/ImpactConstraintHandlerQP.cpp:219-226):
    `lcp_fast_regularized(-20, 4, -8)` then `lcp_lemke_regularized` fallback,
    behind a verified BPP prepass.

    On the card (`cascade=None` and CUDA tensors) the solve is
    `_solve_accel`: BPP, then the PPM kernel, then this plain cascade for
    whatever is left. `device` states where the caller expects to run and
    raises when the tensors are elsewhere.
    """
    _check_device(M, device)
    if _route_accel(M, cascade):
        z, ok, stats = _solve_accel(M, q, mask, z0, skip, _solve_lcp_plain)
    else:
        z, ok, stats = _solve_lcp_plain(M, q, mask, z0, skip, with_stats=True)
    if with_stats:
        return z, ok, stats
    return z, ok


def _solve_lcp_plain(M, q, mask, z0=None, skip=None, with_stats=False):
    skip = _no_skip(skip, q)
    _, _, _, z_bp, ok_bp, piv_bp = _bpp_prepass(M, q, mask, z0, skip)

    z, ok = lcp_fast_regularized(
        M, q, mask, z0=z0, min_exp=-20, step_exp=4, max_exp=-8,
        skip=ok_bp | skip,
    )
    z2, ok2 = lcp_lemke_regularized(M, q, mask, skip=ok_bp | ok | skip)
    z_exact = _bsel(ok, z, z2)
    ok_exact = ok | ok2
    z_out = _bsel(ok_bp, z_bp, z_exact)
    if with_stats:
        stats = LCPStats(pivots=piv_bp, fallback=(~ok_bp & ~skip))
        return z_out, ok_bp | ok_exact, stats
    return z_out, ok_bp | ok_exact
