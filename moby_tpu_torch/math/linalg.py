"""Small batched, mask-aware linear algebra (counterpart of
``moby_tpu/math/linalg.py``). Every function broadcasts over leading batch
dims; masked-out rows/columns are replaced by identity."""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad


def dot3(x, y):
    """x·y over the last axis as the fused multiply-add chain
    fma(x2, y2, fma(x1, y1, x0·y0)) (`torch.addcmul` rounds once): the
    rounding of the JAX package's jitted ``jnp.sum(x * y, axis=-1)`` and
    contractions on the CPU. Where ties or the sign of a near-zero product
    decide (a face's vertices sharing a depth along its normal, a point
    resting on a mesh face), the port then decides as the JAX package does."""
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    return torch.addcmul(torch.addcmul(x0 * y0, x1, y1), x2, y2)


def solve_ex(A, b):
    """A⁻¹·b for A (..., n, n) and b (..., n, k), with no error check: a
    singular system gives non-finite values, which callers read as "not
    solvable", as the JAX package reads `jnp.linalg.solve`'s.

    Which exactly singular systems come out non-finite is decided by the LU's
    rounding. On the CPU in float64 (the regression mode) A is therefore
    factored by LAPACK's ``dgetrf`` as scipy links it, the factorization
    `jnp.linalg.solve` uses on the CPU, and solved from those factors by
    `torch.linalg.lu_solve`: duplicate or coplanar simplex points and
    singular principal subsystems are then dropped in the same cases as in
    the JAX package (MKL's LU, torch's own on the CPU, can leave a pivot of
    rounding size there instead). On the card, and where a gradient or a
    tangent may flow into A, this is `torch.linalg.solve_ex`."""
    if (A.device.type != "cpu" or A.dtype != torch.float64
            or (torch.is_grad_enabled() and A.requires_grad)
            or forward_ad.unpack_dual(A).tangent is not None):
        return torch.linalg.solve_ex(A, b, check_errors=False)[0]
    from scipy.linalg import lapack

    n = A.shape[-1]
    flat = A.detach().reshape(-1, n, n).numpy()
    lu = np.empty_like(flat)
    piv = np.empty(flat.shape[:2], np.int32)
    for i in range(flat.shape[0]):
        lu[i], piv[i], _ = lapack.dgetrf(flat[i])
    LU = torch.from_numpy(lu).reshape(A.shape)
    pivots = torch.from_numpy(piv + 1).reshape(A.shape[:-1])
    return torch.linalg.lu_solve(LU, pivots, b.expand(A.shape[:-2] + b.shape[-2:]))


def _masked_system(M, mask):
    outer = mask[..., :, None] & mask[..., None, :]
    return torch.where(outer, M, 0.0) + torch.diag_embed((~mask).to(M.dtype))


def masked_solve(M, q, mask, rcond_probe=1e-13):
    """Solve M[mask,mask] x = q[mask]; zeros elsewhere.

    Returns (x, ok) where ok=False signals a (near-)singular system, mirroring
    the reference's SingularException path (src/LCP.cpp:122-127).
    """
    A = _masked_system(M, mask)
    b = torch.where(mask, q, 0.0)
    x = torch.linalg.solve_ex(A, b)[0]
    resid = (A @ x[..., None])[..., 0] - b
    scale = A.abs().amax(dim=(-2, -1)).clamp_min(1.0)
    ok = torch.isfinite(x).all(-1) & (
        resid.abs().amax(-1)
        <= rcond_probe ** 0.5 * scale * x.abs().amax(-1).clamp_min(1.0)
    )
    return torch.where(mask, x, 0.0), ok


def cholesky_ok(A, mask=None, jitter=0.0):
    """Whether the masked submatrix of A admits a Cholesky factorization."""
    n = A.shape[-1]
    if mask is not None:
        A = _masked_system(A, mask)
    A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    _, info = torch.linalg.cholesky_ex(A)
    return info == 0


def solve_spd(A, b):
    L = torch.linalg.cholesky_ex(A)[0]
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def solve_spd_masked(A, b, mask):
    """Solve SPD system restricted to mask via Cholesky; zeros elsewhere."""
    x = solve_spd(_masked_system(A, mask), torch.where(mask, b, 0.0))
    return torch.where(mask, x, 0.0)
