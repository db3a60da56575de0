"""Differentiable LCP: implicit-function-theorem gradients through the
contact solve (counterpart of ``moby_tpu/solvers/difflcp.py``).

Forward: a pivoting solve. Backward: at a solution (z, w = Mz + q), the
active set A = {i : z_i > 0} satisfies M_AA z_A + q_A = 0. By the IFT, for
perturbations (dM, dq):

    dz_A = -M_AA^{-1} (dM_A: z + dq_A),   dz_{A^c} = 0

so the VJP pulls cotangents back through one masked linear solve:

    gbar_A = -M_AA^{-T} zbar_A
    qbar   = gbar,    Mbar = gbar z^T      (restricted to active rows)

Degenerate contacts (z_i = 0, w_i = 0) get the subgradient with the active
side chosen by z > tol — the standard choice for contact-implicit trajectory
optimization.

Everything carries the batch as its leading dimension: M (B, n, n), q, mask,
z0 (B, n), skip (B,). Three forward variants share the same VJP, each a
`torch.autograd.Function` whose gradients flow to M and q only:

* :func:`solve_lcp_diff` — the full production cascade (`lcp.solve_lcp`).
* :func:`solve_lcp_diff_mpc` — the MPC hot path (`_mpc_forward`): verified
  block pivoting, then the same on Tikhonov-regularized matrices (single λ,
  then a short ladder), then `lcp_fast_regularized`, then a NaN poison.
* :func:`solve_lcp_given` — replays a recorded solution.

:func:`solve_lcp_given` also carries the IFT derivative as a forward-mode
rule (`jvp`), for the forward-mode linearization of the MPC step
(`solve_lcp_given_fwd` is another name for it).

The inverse of the active block is computed once in the forward, and only
when M or q requires a gradient; every backward is then a matvec.

Routing of `_mpc_forward`. On CUDA tensors whose problem fits one thread
block (`hopper_lcp.fits`, decided statically) every "block pivoting +
verification" pair of the cascade is one launch of the hand-written kernel
`hopper_lcp.bpp_lcp`, which runs each problem's own iterations on the device
and returns the verified flag. On the CPU, and above the size gate, the pair
is the batched `lcp.lcp_bpp` loop and `lcp._verify`. ``cascade="accel"`` in
the options forces the kernel route on a CPU tensor, with the kernel's plain
version in its place (tests); ``"plain"`` forces the batched route.

The options of this path are one explicit object, :class:`MPCOptions`; the
port reads no environment variable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import config as cfg
from . import lcp as lcp_mod


@dataclass(frozen=True)
class MPCOptions:
    """Options of the contact-MPC path, with the JAX package's defaults.

    ift_compact_na: active-set cap of the compacted IFT inverse (float32,
        problems with n > max(cap, 48) only); an active set above the cap
        poisons the pullback with NaN.
    bpp_iters: block-pivoting iterations of every stage of the cascade.
    ppm_rescue: run the PPM kernel on what stage 1 failed, before the
        regularized stages.
    lam_scale: the stage-2 regularizer is lam_scale·sqrt(eps)·‖M‖∞.
    stage2: run stage 2 (single-λ regularized block pivoting).
    ladder: multiples of the stage-2 λ tried after it, in order.
    rescue: run `lcp_fast_regularized` on what every earlier stage failed.
    line_search_steps: step sizes 1.1^(-k²), k < line_search_steps, of the
        iLQR line search.
    cascade: None routes by device ("accel" on CUDA, "plain" on the CPU);
        "accel" or "plain" forces the route.
    block_jac: the forward-mode linearization (`solve_batch(linearize_fwd=
        True)`) uses the block-sparse linearizer `contact_mpc`'s `f_jac`
        instead of forward mode through the whole replay step.
    riccati_bf16: the quadratic form FᵀVF of the Riccati recursion takes F
        and Vxx rounded to bfloat16 and accumulates in the working dtype.
    """

    ift_compact_na: int = 32
    bpp_iters: int = 12
    ppm_rescue: bool = False
    lam_scale: float = 10.0
    stage2: bool = True
    ladder: Tuple[float, ...] = (30.0, 1000.0)
    rescue: bool = True
    line_search_steps: int = 8
    cascade: Optional[str] = None
    block_jac: bool = True
    riccati_bf16: bool = False


DEFAULT_OPTIONS = MPCOptions()


def _compact_cap(n: int, options: MPCOptions = DEFAULT_OPTIONS) -> int:
    """Static active-set cap for the compacted IFT inverse (0 = disabled).

    The solution active set of the monotone QP-KKT impact LCP is small (its
    positive components are the pushing impulse directions + binding
    multipliers), while the padded LCP dimension n grows with
    contact/friction/limit slots. Compacting to the NA first active slots
    cuts the depth of the Gauss–Jordan inverse from n to NA."""
    na = int(options.ift_compact_na)
    if n <= max(na, 48):  # small problems: full inverse is already cheap
        return 0
    return na


def _prep_bwd(M, z, mask, transpose: bool = True,
              options: MPCOptions = DEFAULT_OPTIONS):
    """Residuals for the IFT pullback: the active set and the explicit
    inverse of the masked system M_AA^T (or M_AA with `transpose=False`).

    The pullback is linear in zbar and a step Jacobian evaluates it once per
    output row; inverting M_AA^T ONCE here turns every pullback into a
    matvec.

    The active block is Tikhonov-regularized before inverting: contact-LCP
    active sets are routinely rank-deficient (redundant manifold points,
    friction splits), so the exact M_AA^{-1} need not exist. The λ·I shift
    with λ = sqrt(eps)·‖Mᵀ‖∞ selects the smoothed element of the IFT
    subdifferential and perturbs well-conditioned blocks by O(λ/σ_min).

    For large float32 problems (see `_compact_cap`) the inverse is computed
    on the NA-compacted active block: residuals are (inv_c (B, NA, NA),
    P (B, NA, n)) with the implicit identity Ainv_T = Pᵀ inv_c P.
    """
    dtype = M.dtype
    B, n = z.shape
    active = (z > 1e-10) & mask
    MT = M.transpose(-1, -2) if transpose else M
    lam = (cfg.eps(dtype) ** 0.5) * lcp_mod._masked_norm_inf(MT, mask)   # (B,)
    na = _compact_cap(n, options) if lcp_mod._use_gj(dtype) else 0
    if na:
        # compact: gather the active rows/cols of Mᵀ to the top-left NA x NA
        # block via a stable actives-first permutation
        idx = torch.argsort((~active).to(torch.int8), dim=1, stable=True)[:, :na]
        cnt = active.sum(dim=1)
        P = torch.nn.functional.one_hot(idx, n).to(dtype)        # (B, NA, n)
        rowm = torch.arange(na, device=z.device)[None, :] < cnt[:, None]
        sub = (P @ MT) @ P.transpose(-1, -2)                      # (B, NA, NA)
        subm = torch.where(rowm[:, :, None] & rowm[:, None, :], sub, 0.0) \
            + torch.diag_embed(torch.where(rowm, lam[:, None], 1.0).to(dtype))
        inv_c, ok = lcp_mod.gj_invert_masked(subm, rowm)
        # active set exceeding the cap: poison the pullback (NaN) so the
        # caller's isfinite guard rejects the step instead of silently using
        # a truncated inverse
        bad = (cnt > na) | ~ok
        inv_c = torch.where(bad[:, None, None], torch.nan, inv_c)
        return active, (inv_c, P)
    outer = active[:, :, None] & active[:, None, :]
    A_T = torch.where(outer, MT, 0.0) + torch.diag_embed(
        torch.where(active, lam[:, None], 1.0).to(dtype))
    if lcp_mod._use_gj(dtype):
        Ainv_T, ok = lcp_mod.gj_invert_masked(A_T, active)
    else:
        Ainv_T, info = torch.linalg.inv_ex(A_T)
        ok = (info == 0) & torch.isfinite(Ainv_T).all(dim=-1).all(dim=-1)
    Ainv_T = torch.where(ok[:, None, None], Ainv_T, 0.0)
    return active, Ainv_T


def _ift_bwd(active, Ainv_T, z, zbar):
    zb = torch.where(active, zbar, 0.0)
    if isinstance(Ainv_T, tuple):
        inv_c, P = Ainv_T
        # gbar_A = -(Pᵀ inv_c P) zbar_A: compact matvecs, no scatter
        gbar = -(P.transpose(-1, -2) @ (inv_c @ (P @ zb[..., None])))[..., 0]
    else:
        # gbar_A = -M_AA^{-T} zbar_A  (precomputed inverse; see _prep_bwd)
        gbar = -(Ainv_T @ zb[..., None])[..., 0]
    gbar = torch.where(active, gbar, 0.0)
    Mbar = gbar[:, :, None] * z[:, None, :]
    qbar = gbar
    return Mbar, qbar


def _save_ift(ctx, M, z, mask, options):
    """Shared `setup_context`: the IFT residuals, only when a gradient can
    be asked for."""
    ctx.has_ift = bool(ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
    ctx.compact = False
    if not ctx.has_ift:
        return
    with torch.no_grad():
        active, Ainv_T = _prep_bwd(M, z, mask, options=options)
    if isinstance(Ainv_T, tuple):
        ctx.compact = True
        ctx.save_for_backward(active, z, *Ainv_T)
    else:
        ctx.save_for_backward(active, z, Ainv_T)


def _pull_back(ctx, zbar):
    active, z, *res = ctx.saved_tensors
    Ainv_T = tuple(res) if ctx.compact else res[0]
    return _ift_bwd(active, Ainv_T, z, zbar)


class _SolveLCPDiff(torch.autograd.Function):
    @staticmethod
    def forward(M, q, mask, z0, cascade, device):
        z, _ = lcp_mod.solve_lcp(M, q, mask, z0=z0, cascade=cascade,
                                 device=device)
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, mask = inputs[:3]
        _save_ift(ctx, M, output, mask, DEFAULT_OPTIONS)

    @staticmethod
    def backward(ctx, zbar):
        Mbar, qbar = _pull_back(ctx, zbar)
        return Mbar, qbar, None, None, None, None


def solve_lcp_diff(M, q, mask, z0=None, cascade=None, device="cuda"):
    """z of the production cascade `lcp.solve_lcp`, differentiable in M and
    q by the IFT. `device` states where the caller expects to run and raises
    when the tensors are elsewhere."""
    return _SolveLCPDiff.apply(M, q, mask, z0, cascade, device)


class _SolveLCPDiffMPC(torch.autograd.Function):
    @staticmethod
    def forward(M, q, mask, z0, skip, options):
        z, _ = _mpc_forward(M, q, mask, z0, skip, options)
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, mask, _, _, options = inputs
        _save_ift(ctx, M, output, mask, options)

    @staticmethod
    def backward(ctx, zbar):
        Mbar, qbar = _pull_back(ctx, zbar)
        return Mbar, qbar, None, None, None, None


def solve_lcp_diff_mpc(M, q, mask, z0=None, skip=None,
                       options: MPCOptions = DEFAULT_OPTIONS):
    """z of the MPC cascade (`_mpc_forward`), differentiable in M and q by
    the IFT. Honors `skip`, so gated solves cost no pivot iterations."""
    return _SolveLCPDiffMPC.apply(
        M, q, mask, z0, lcp_mod._no_skip(skip, q), options)


class _SolveLCPGiven(torch.autograd.Function):
    @staticmethod
    def forward(M, q, mask, z, options):
        return z.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, _, mask, z, options = inputs
        _save_ift(ctx, M, z, mask, options)
        ctx.save_for_forward(M, mask, z)
        ctx.options = options

    @staticmethod
    def backward(ctx, zbar):
        Mbar, qbar = _pull_back(ctx, zbar)
        return Mbar, qbar, None, None, None

    @staticmethod
    def jvp(ctx, dM, dq, _dmask, _dz, _doptions):
        M, mask, z = ctx.saved_tensors
        with torch.no_grad():
            active, Ainv = _prep_bwd(M, z, mask, transpose=False,
                                     options=ctx.options)
        rhs = torch.zeros_like(z)
        if dM is not None:
            rhs = rhs + (dM @ z[..., None])[..., 0]
        if dq is not None:
            rhs = rhs + dq
        rhs = torch.where(active, rhs, 0.0)
        if isinstance(Ainv, tuple):
            inv_c, P = Ainv
            dz = -(P.transpose(-1, -2) @ (inv_c @ (P @ rhs[..., None])))[..., 0]
        else:
            dz = -(Ainv @ rhs[..., None])[..., 0]
        return torch.where(active, dz, 0.0)


def solve_lcp_given(M, q, mask, z, options: MPCOptions = DEFAULT_OPTIONS):
    """Replay a known LCP solution with the same IFT gradients as the live
    solves above.

    The iLQR backward pass linearizes the dynamics at states the accepted
    rollout ALREADY stepped through: the rollout's pivoting solve produced z
    there. The primal here just returns the recorded z; the VJP is the
    identical `_ift_bwd` pullback evaluated at it. z is data (its cotangent
    is dropped), exactly as the live solvers expose gradients only through
    (M, q).

    The same derivative is also a forward-mode rule (`jvp`), for the
    forward-mode linearization: tangents of M and q come from
    `torch.autograd.forward_ad` dual tensors and, on the active set A,

        dz_A = -M_AA^{-1} (dM_A z + dq_A),   dz = 0 off A,

    from the inverse of `_prep_bwd(M, z, mask, transpose=False)` (its
    compacted form included); z's tangent is ignored."""
    return _SolveLCPGiven.apply(M, q, mask, z, options)


# the JAX package's name for the forward-mode replay (a custom_jvp there,
# where custom_vjp and custom_jvp cannot share one function)
solve_lcp_given_fwd = solve_lcp_given


def _use_kernel(M, options: MPCOptions) -> bool:
    """Whether the cascade's block-pivoting pairs go to `hopper_lcp.bpp_lcp`:
    on CUDA tensors (or with cascade="accel"), and only when the problem
    fits one thread block — decided statically, never by catching a failed
    launch."""
    from . import hopper_lcp

    return (lcp_mod._route_accel(M, options.cascade)
            and hopper_lcp.fits(M.shape[-1], M.dtype))


def _mpc_forward(M, q, mask, z0, skip, options: MPCOptions = DEFAULT_OPTIONS):
    """The MPC solve cascade -> (z, ok). Stage by stage:

    1. block pivoting, `bpp_iters` iterations, verified;
    1b. optional (`ppm_rescue`): the PPM kernel on what stage 1 failed;
    2. the same on M + λI with λ = lam_scale·sqrt(eps)·‖M‖∞, verified against
       the REGULARIZED matrix, as the reference's regularized wrappers do
       (src/LCP.cpp:239-260);
    3. the ladder: the same at λ·mult for each mult of `ladder`;
    4. `lcp_fast_regularized`, the production Tikhonov sweep (with the
       ladder in front it fires almost never: all-skipped, it leaves at its
       first check);
    5. every stage failed and the problem was not skipped: z is poisoned
       with NaN, so that the iLQR line search rejects the rollout instead of
       using a non-solution.
    """
    from . import hopper_lcp

    dtype = M.dtype
    n = q.shape[-1]
    skip = lcp_mod._no_skip(skip, q)
    Mp, qp = lcp_mod.pad_lcp(M, q, mask)
    check_tol = lcp_mod._check_tol(Mp, mask)
    kernel = _use_kernel(M, options)

    def bpp_pair(Mx, qx, skip_x):
        """One verified block-pivoting solve of (Mx, qx), skipping skip_x,
        checked at the tolerance of M (not of Mx) on both routes."""
        if kernel:
            m_eff = mask & ~skip_x[:, None]
            z_, ok_ = hopper_lcp.bpp_lcp(
                Mx.contiguous(), qx.contiguous(), m_eff,
                None if z0 is None else z0.contiguous(),
                max_bpp=options.bpp_iters, check_tol=check_tol.contiguous())
            return z_, ok_ & ~skip_x
        z_, ok_ = lcp_mod.lcp_bpp(Mx, qx, mask, z0=z0, skip=skip_x,
                                  max_iters=options.bpp_iters)
        return z_, ok_ & lcp_mod._verify(Mx, qx, z_, mask, check_tol)

    z, ok = bpp_pair(Mp, qp, skip)
    if options.ppm_rescue:
        # per-problem PPM between stage 1 and the regularized stages: each
        # thread block runs exactly its own pivot count
        m_eff = mask & ~(skip | ok)[:, None]
        z0_eff = None if z0 is None else torch.where(m_eff, z0, 0.0)
        z_pl, done_pl = hopper_lcp.ppm_lcp(
            M.contiguous(), q.contiguous(), m_eff, z0=z0_eff)
        ok_pl = (done_pl & lcp_mod._verify(Mp, qp, z_pl, m_eff, check_tol)
                 & ~ok & ~skip & m_eff.any(dim=-1))
        z = lcp_mod._bsel(ok_pl, z_pl, z)
        ok = ok | ok_pl
    lam = (options.lam_scale * cfg.eps(dtype) ** 0.5) \
        * lcp_mod._masked_norm_inf(Mp, mask)                         # (B,)
    eye_m = torch.diag_embed(mask.to(dtype))
    if options.stage2:
        Mreg = Mp + lam[:, None, None] * eye_m
        z_rg, ok_rg = bpp_pair(Mreg, qp, skip | ok)
        z = lcp_mod._bsel(ok, z, z_rg)
        ok = ok | ok_rg
    for mult in options.ladder:
        Mreg_i = Mp + (lam * float(mult))[:, None, None] * eye_m
        z_i, ok_i = bpp_pair(Mreg_i, qp, skip | ok)
        z = lcp_mod._bsel(ok, z, z_i)
        ok = ok | ok_i
    if options.rescue:
        z3, ok3 = lcp_mod.lcp_fast_regularized(M, q, mask, z0=z0, skip=ok | skip)
        z = lcp_mod._bsel(ok, z, z3)
        ok = ok | ok3
    good = ok | skip
    z = torch.where(good[:, None], z, torch.nan)
    return z, ok
