"""Small batched, mask-aware linear algebra (counterpart of
``moby_tpu/math/linalg.py``). Every function broadcasts over leading batch
dims; masked-out rows/columns are replaced by identity."""

from __future__ import annotations

import torch


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
