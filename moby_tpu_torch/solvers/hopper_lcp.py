"""The principal-pivoting LCP kernel for Hopper, its wrapper and its plain
version (counterpart of ``moby_tpu/solvers/pallas_lcp.py``: the PPM kernel).

`ppm_lcp` replaces the TPU kernel body `_ppm_kernel_impl` behind both of its
entries: `ppm_lcp_one` (warm-started, the one the production cascade
`lcp._solve_accel` reaches) and `ppm_lcp_batched` (cold, the `z0=None` case).
The kernel is CUDA C++ (`csrc/ppm_lcp.cu`), one thread block per problem,
built by `nvcc` for sm_90a at first use into ``moby_tpu_torch/build/`` and
loaded with `ctypes`; importing this module builds and loads nothing.

What bounds it on the card: the serial depth of the pivot chain (each pivot
is up to n dependent Gauss–Jordan steps, two block barriers each), not bytes
or operations. The design answers with one block per problem (each runs its
own pivot count, solved problems leave at once), the whole problem resident
in shared memory, and elimination restricted to the nonbasic rows and the
columns right of the pivot. See the note at the head of the CUDA source.

`ppm_lcp_plain` is the same function in batched PyTorch. The CPU tests and
the on-card comparison use it; `ppm_lcp` takes it only for a CPU tensor. For
a CUDA tensor the wrapper launches the kernel or raises.

Semantics shared by kernel and plain version (lines of the Pallas source):
`ztol = m_active·‖M‖∞·eps` over the active submatrix (:83-88); first-minimum
selection takes the lowest index among equal minima (:97-103); `trivial`
comes from the cold rule `min q > -ztol` even with a warm start and zeroes z,
so an all-false mask is trivial with done=1 (:105-106, :197); the warm start
replaces the cold seed only if some |z0| >= ztol (:108-114); the
Gauss–Jordan skips a step whose |pivot| <= 1e-30 and leaves the system as it
was (:133-147) — unlike `lcp.gj_solve_masked`, which zeroes the row;
each pivot adds the first index with w < -ztol and drops the first with
z < -ztol (:161-173); at most 2n+8 pivots with the unpadded n (:215-216);
z is zeroed unless done (:197). Minima propagate NaN (as `jnp.min` does), so
a singular sub-solve that poisons z ends with done=0 in both versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from .. import config as cfg

WARP = 32
# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT_BYTES = 232448

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "ppm_lcp.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libppm_lcp.so")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_log = ""   # nvcc's output of the last build (registers, shared memory)


def _round_up(x, m):
    return (x + m - 1) // m * m


def padded_size(n: int) -> int:
    """n rounded up to a whole number of warps."""
    return _round_up(max(int(n), 1), WARP)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of one block: the masked M (np²), the working
    matrix with the right-hand side as its last column (np·(np+1)), three
    vectors, three int flag vectors."""
    np_ = padded_size(n)
    size = 8 if cfg.torch_dtype(dtype) == torch.float64 else 4
    return (2 * np_ * np_ + 4 * np_) * size + 3 * np_ * 4


def fits(n: int, dtype) -> bool:
    """Whether an n-variable problem of this dtype fits one thread block's
    shared memory: n <= 160 in float32, n <= 96 in float64. The accelerated
    cascade decides from this, statically, whether its kernel stage exists."""
    return smem_bytes(n, dtype) <= SMEM_LIMIT_BYTES


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build(force: bool = False) -> str:
    """Compile `csrc/ppm_lcp.cu` into the shared library (if it is missing or
    older than the source) and return its path. A failed build raises with
    the compiler's output."""
    global build_log
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE)):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = _LIB_PATH + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ppm_lcp_f32, lib.ppm_lcp_f64):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.ppm_lcp_smem_bytes.argtypes = [i32, i32]
        lib.ppm_lcp_smem_bytes.restype = ctypes.c_longlong
        lib.ppm_lcp_error_string.argtypes = [i32]
        lib.ppm_lcp_error_string.restype = ctypes.c_char_p
        for size, dt in ((4, torch.float32), (8, torch.float64)):
            if lib.ppm_lcp_smem_bytes(96, size) != smem_bytes(96, dt):
                raise RuntimeError(
                    "shared-memory layout of csrc/ppm_lcp.cu and "
                    "hopper_lcp.smem_bytes disagree")
        _lib = lib
    return _lib


def ppm_lcp(M, q, mask, z0=None, max_piv=None):
    """Solve B LCPs by warm-started principal pivoting.

    M (B, n, n), q (B, n), mask (B, n) bool, z0 (B, n) or None (cold start)
    -> (z (B, n), done (B,) bool). `done` is the solver's own convergence
    flag; callers verify the solution before accepting it.

    A CPU tensor goes to `ppm_lcp_plain`. A CUDA tensor launches the kernel
    on the current stream (no synchronisation) or raises: on a wrong dtype,
    shape or layout, on a problem too large for the block's shared memory
    (`fits`), on a build or launch error. `ppm_lcp.launches` counts the
    kernel launches.
    """
    if M.device.type == "cpu":
        return ppm_lcp_plain(M, q, mask, z0=z0, max_piv=max_piv)
    if M.device.type != "cuda":
        raise ValueError(f"ppm_lcp: unsupported device {M.device}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ppm_lcp: float32 or float64 expected, got {M.dtype}")
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"ppm_lcp: M must be (B, n, n), got {tuple(M.shape)}")
    B, n, _ = M.shape
    for name, t in (("q", q), ("mask", mask), ("z0", z0)):
        if t is None:
            continue
        if tuple(t.shape) != (B, n):
            raise ValueError(
                f"ppm_lcp: {name} must be ({B}, {n}), got {tuple(t.shape)}")
        if t.device != M.device:
            raise ValueError(f"ppm_lcp: {name} is on {t.device}, M on {M.device}")
        if name != "mask" and t.dtype != M.dtype:
            raise TypeError(f"ppm_lcp: {name} is {t.dtype}, M is {M.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"ppm_lcp: mask must be bool, got {mask.dtype}")
    for name, t in (("M", M), ("q", q), ("mask", mask), ("z0", z0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ppm_lcp: {name} must be contiguous")
    if not fits(n, M.dtype):
        raise ValueError(
            f"ppm_lcp: n={n} in {M.dtype} needs {smem_bytes(n, M.dtype)} bytes "
            f"of shared memory, a block has {SMEM_LIMIT_BYTES}")
    if max_piv is None:
        max_piv = 2 * n + 8

    lib = _load()
    z = torch.empty_like(q)
    # mask and done cross as torch.bool: one byte each, 0 or 1
    done = torch.empty(B, dtype=torch.bool, device=M.device)
    if B == 0 or n == 0:
        return z.zero_(), done.fill_(True)
    fn = lib.ppm_lcp_f32 if M.dtype == torch.float32 else lib.ppm_lcp_f64
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(M.data_ptr(), q.data_ptr(), mask.data_ptr(),
                None if z0 is None else z0.data_ptr(),
                z.data_ptr(), done.data_ptr(), B, n, padded_size(n),
                int(max_piv), stream)
    if rc != 0:
        raise RuntimeError(
            f"ppm_lcp: kernel launch failed with CUDA error {rc}: "
            f"{lib.ppm_lcp_error_string(rc).decode()}")
    ppm_lcp.launches += 1
    return z, done


ppm_lcp.launches = 0


def _first_min(v, sel, arange, n):
    """(one-hot (B, n), min (B,)) of the first minimum of v over sel;
    NaN-propagating (an all-false one-hot when the minimum is NaN)."""
    vm = torch.where(sel, v, torch.inf)
    mn = vm.amin(dim=-1)
    is_min = (vm == mn[:, None]) & sel
    first_idx = torch.where(is_min, arange, n).amin(dim=-1)
    return arange == first_idx[:, None], mn


def _solve_masked_plain(Mp, qv, nb, steps):
    """Gauss–Jordan of the nb-masked systems A z = -q, skipping a step whose
    |pivot| <= 1e-30 (the system stays as it was). `steps` lists the pivot
    positions that are nonbasic in at least one problem: the others are
    identity steps."""
    outer = nb[:, :, None] & nb[:, None, :]
    A = torch.where(outer, Mp, 0.0) + torch.diag_embed((~nb).to(Mp.dtype))
    b = torch.where(nb, -qv, 0.0)
    for k in steps:
        pivot = A[:, k, k]
        piv_ok = pivot.abs() > 1e-30
        inv_p = 1.0 / torch.where(piv_ok, pivot, 1.0)
        prow = A[:, k, :] * inv_p[:, None]
        pb = b[:, k] * inv_p
        factor = A[:, :, k].clone()
        factor[:, k] = 0.0
        A2 = A - factor[:, :, None] * prow[:, None, :]
        b2 = b - factor * pb[:, None]
        A2[:, k, :] = prow
        b2[:, k] = pb
        A = torch.where(piv_ok[:, None, None], A2, A)
        b = torch.where(piv_ok[:, None], b2, b)
    return torch.where(nb, b, 0.0)


def ppm_lcp_plain(M, q, mask, z0=None, max_piv=None, with_pivots=False):
    """`ppm_lcp` in batched PyTorch: the same pivoting, as a loop of masked
    batched iterations that ends when every problem is done or out of
    pivots. Works on any device; nothing on the card's main path calls it.
    `with_pivots` adds the pivots each problem took, (B,) int64, and the size
    of the nonbasic system it solved at each of them, (P, B) int64 with 0
    where the problem had already ended (P: the pivots of the longest)."""
    B, n = q.shape
    dtype, device = M.dtype, M.device
    if max_piv is None:
        max_piv = 2 * n + 8
    valid = mask
    arange = torch.arange(n, device=device)[None, :]

    vout = valid[:, :, None] & valid[:, None, :]
    rowsum = torch.where(vout, M, 0.0).abs().sum(dim=2)
    norminf = torch.where(valid, rowsum, 0.0).amax(dim=1)
    m_active = valid.sum(dim=1).to(dtype)
    ztol = m_active * norminf * cfg.eps(dtype)

    qv = torch.where(valid, q, 1.0)
    Mp = torch.where(vout, M, 0.0) + torch.diag_embed((~valid).to(dtype))

    start_mask, minq = _first_min(qv, valid, arange, n)
    trivial = minq > -ztol
    nonbas = start_mask & ~trivial[:, None]
    if z0 is not None:
        warm = (z0.abs() >= ztol[:, None]) & valid
        any_warm = warm.any(dim=1)
        nonbas = torch.where(any_warm[:, None], warm, nonbas)

    z = torch.zeros_like(q)
    done = trivial.clone()
    pivots = torch.zeros(B, dtype=torch.int64, device=device)
    nb_sizes = []
    piv = 0
    while piv < max_piv:
        active = ~done
        if not bool(active.any()):
            break
        steps = torch.nonzero((nonbas & active[:, None]).any(dim=0))[:, 0].tolist()
        z_nb = _solve_masked_plain(Mp, qv, nonbas, steps)
        nb_sizes.append(torch.where(active, nonbas.sum(dim=1), 0))
        bas = valid & ~nonbas
        w = torch.where(bas, (Mp @ z_nb[..., None])[..., 0] + qv, 0.0)

        wmask, minw = _first_min(w, bas, arange, n)
        zmask, minz = _first_min(z_nb, nonbas, arange, n)
        w_ok = minw > -ztol
        z_neg = minz < -ztol
        solved = w_ok & ~z_neg
        nonbas2 = (nonbas | (wmask & ~w_ok[:, None])) & ~(zmask & z_neg[:, None])
        upd = active & ~solved
        nonbas = torch.where(upd[:, None], nonbas2, nonbas)
        z = torch.where(active[:, None], z_nb, z)
        done = done | (active & solved)
        pivots += active
        piv += 1

    z_out = torch.where(valid & (~trivial & done)[:, None], z, 0.0)
    if with_pivots:
        sizes = (torch.stack(nb_sizes) if nb_sizes
                 else pivots.new_zeros((0, B)))
        return z_out, done, pivots, sizes
    return z_out, done
