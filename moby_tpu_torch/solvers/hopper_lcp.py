"""The LCP kernels for Hopper, their wrappers and their plain versions
(counterpart of ``moby_tpu/solvers/pallas_lcp.py``).

`ppm_lcp` replaces the TPU kernel body `_ppm_kernel_impl` behind both of its
entries: `ppm_lcp_one` (warm-started, the one the production cascade
`lcp._solve_accel` reaches) and `ppm_lcp_batched` (cold, the `z0=None` case).
`bpp_lcp` replaces `_bpp_kernel_body` behind `bpp_lcp_one` and
`bpp_lcp_batched`: block principal pivoting, then principal pivoting from its
last basis, then the complementarity check, so that one launch stands for a
whole "batched BPP loop + `_verify`" pair; the contact-MPC cascade
(`difflcp._mpc_forward`) launches it for every such pair.

Both kernels are CUDA C++ (`csrc/ppm_lcp.cu`, `csrc/bpp_lcp.cu`, shared
device code in `csrc/lcp_common.cuh`), one thread block per problem, built by
`nvcc` for sm_90a at first use into ``moby_tpu_torch/build/`` (one `nvcc` per
source, started together) and loaded with `ctypes`; importing this module
builds and loads nothing.

What bounds them on the card: the serial depth of the pivot chain (each pivot
is up to n dependent Gauss–Jordan steps, two block barriers each), not bytes
or operations. The design answers with one block per problem (each runs its
own pivot count, solved problems leave at once), the whole problem resident
in shared memory, and elimination restricted to the nonbasic rows and the
columns right of the pivot. See the notes at the head of the CUDA sources.

`ppm_lcp_plain` and `bpp_lcp_plain` are the same functions in batched
PyTorch. The CPU tests and the on-card comparison use them; a wrapper takes
its plain version only for a CPU tensor. For a CUDA tensor it launches the
kernel or raises.

Semantics shared by the PPM kernel and its plain version (lines of the Pallas
source): `ztol = m_active·‖M‖∞·eps` over the active submatrix (:83-88);
first-minimum selection takes the lowest index among equal minima (:97-103);
`trivial` comes from the cold rule `min q > -ztol` even with a warm start and
zeroes z, so an all-false mask is trivial with done=1 (:105-106, :197); the
warm start replaces the cold seed only if some |z0| >= ztol (:108-114); the
Gauss–Jordan skips a step whose |pivot| <= 1e-30 and leaves the system as it
was (:133-147) — unlike `lcp.gj_solve_masked`, which zeroes the row; each
pivot adds the first index with w < -ztol and drops the first with z < -ztol
(:161-173); at most 2n+8 pivots with the unpadded n (:215-216); z is zeroed
unless done (:197). Minima propagate NaN (as `jnp.min` does), so a singular
sub-solve that poisons z ends with done=0 in both versions.

Semantics of the BPP kernel and its plain version: the same ztol and
`check_tol = m_active·‖M‖∞·sqrt(eps)` (:310-316); the start set is the warm
start's support |z0| >= ztol if it has any, else {q < -ztol}, and `trivial`
is "the start set is empty" (:373-377), not the PPM rule; an iteration is
solved iff it has no violator (z < -ztol inside the set, w < -ztol outside);
the budget of block flips resets to 3 on a strict improvement of the
violator count, else drops by one, and at 0 only the violator of least index
is flipped (:399-432); at most `max_bpp` iterations; then the PPM stage from
the last set, only when the block stage did not finish (:459-497); z is zero
unless finished and not trivial (:498-499); `ok = (finished and checked) or
trivial` (:507-516). A NaN iterate has no violator (comparisons with NaN are
false), so the block stage calls itself finished and only the check's
NaN-propagating minima give ok=0.
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
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_HEADER = os.path.join(_CSRC_DIR, "lcp_common.cuh")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNELS = ("ppm_lcp", "bpp_lcp")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs = None
build_log = ""   # nvcc's output of the last build (registers, shared memory)


def _source(name: str) -> str:
    return os.path.join(_CSRC_DIR, name + ".cu")


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"lib{name}.so")


def _round_up(x, m):
    return (x + m - 1) // m * m


def padded_size(n: int) -> int:
    """n rounded up to a whole number of warps."""
    return _round_up(max(int(n), 1), WARP)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of one block, the same for both kernels: the
    masked M (np²), the working matrix with the right-hand side as its last
    column (np·(np+1)), three vectors, three int flag vectors."""
    np_ = padded_size(n)
    size = 8 if cfg.torch_dtype(dtype) == torch.float64 else 4
    return (2 * np_ * np_ + 4 * np_) * size + 3 * np_ * 4


def fits(n: int, dtype) -> bool:
    """Whether an n-variable problem of this dtype fits one thread block's
    shared memory: n <= 160 in float32, n <= 96 in float64. The cascades
    decide from this, statically, whether their kernel stages exist."""
    return smem_bytes(n, dtype) <= SMEM_LIMIT_BYTES


def _nvcc() -> str:
    """nvcc from the PATH, else from the toolkit's usual place."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return built < max(os.path.getmtime(_source(name)),
                       os.path.getmtime(_HEADER))


def build(force: bool = False) -> dict:
    """Compile every kernel source whose shared library is missing or older
    than its source or the shared header, one `nvcc` each, all started
    together. Returns {kernel name: library path}. A failed build raises
    with the compiler's output."""
    global build_log
    todo = [k for k in KERNELS if force or _stale(k)]
    if todo:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        procs = []
        for name in todo:
            tmp = _lib_path(name) + f".{os.getpid()}.tmp"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _source(name)]
            procs.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        build_log = ""
        failed = []
        for name, tmp, cmd, proc in procs:
            out, _ = proc.communicate()
            build_log += out
            if proc.returncode != 0:
                failed.append(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    return {k: _lib_path(k) for k in KERNELS}


def _load() -> dict:
    """{kernel name: its loaded library}, building first where needed."""
    global _libs
    if _libs is None:
        paths = build()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        libs = {}
        for name in KERNELS:
            lib = ctypes.CDLL(paths[name])
            # ppm: (M, q, mask, z0, z, ok, B, n, np, max_piv, stream);
            # bpp has max_bpp before max_piv
            n_int = 4 if name == "ppm_lcp" else 5
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = [ptr] * 6 + [i32] * n_int + [ptr]
                fn.restype = i32
            smem = getattr(lib, name + "_smem_bytes")
            smem.argtypes = [i32, i32]
            smem.restype = ctypes.c_longlong
            err = getattr(lib, name + "_error_string")
            err.argtypes = [i32]
            err.restype = ctypes.c_char_p
            for size, dt in ((4, torch.float32), (8, torch.float64)):
                if smem(96, size) != smem_bytes(96, dt):
                    raise RuntimeError(
                        f"shared-memory layout of csrc/{name}.cu and "
                        "hopper_lcp.smem_bytes disagree")
            libs[name] = lib
        _libs = libs
    return _libs


def _check_inputs(who, M, q, mask, z0):
    """Raise on what the kernels do not take; returns (B, n)."""
    if M.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {M.device}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: float32 or float64 expected, got {M.dtype}")
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"{who}: M must be (B, n, n), got {tuple(M.shape)}")
    B, n, _ = M.shape
    for name, t in (("q", q), ("mask", mask), ("z0", z0)):
        if t is None:
            continue
        if tuple(t.shape) != (B, n):
            raise ValueError(
                f"{who}: {name} must be ({B}, {n}), got {tuple(t.shape)}")
        if t.device != M.device:
            raise ValueError(f"{who}: {name} is on {t.device}, M on {M.device}")
        if name != "mask" and t.dtype != M.dtype:
            raise TypeError(f"{who}: {name} is {t.dtype}, M is {M.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{who}: mask must be bool, got {mask.dtype}")
    for name, t in (("M", M), ("q", q), ("mask", mask), ("z0", z0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if not fits(n, M.dtype):
        raise ValueError(
            f"{who}: n={n} in {M.dtype} needs {smem_bytes(n, M.dtype)} bytes "
            f"of shared memory, a block has {SMEM_LIMIT_BYTES}")
    return B, n


def _launch(who, M, q, mask, z0, ints):
    """Launch kernel `who` on the current stream; returns (z, ok)."""
    B, n = q.shape
    lib = _load()[who]
    z = torch.empty_like(q)
    # mask and ok cross as torch.bool: one byte each, 0 or 1
    ok = torch.empty(B, dtype=torch.bool, device=M.device)
    if B == 0 or n == 0:
        return z.zero_(), ok.fill_(True)
    fn = getattr(lib, who + ("_f32" if M.dtype == torch.float32 else "_f64"))
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(M.data_ptr(), q.data_ptr(), mask.data_ptr(),
                None if z0 is None else z0.data_ptr(),
                z.data_ptr(), ok.data_ptr(), B, n, padded_size(n),
                *(int(i) for i in ints), stream)
    if rc != 0:
        msg = getattr(lib, who + "_error_string")(rc).decode()
        raise RuntimeError(
            f"{who}: kernel launch failed with CUDA error {rc}: {msg}")
    return z, ok


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
    _, n = _check_inputs("ppm_lcp", M, q, mask, z0)
    if max_piv is None:
        max_piv = 2 * n + 8
    z, done = _launch("ppm_lcp", M, q, mask, z0, (max_piv,))
    if z.numel():
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


def _problem_plain(M, q, mask):
    """What both plain versions start from: (Mp, qv, ‖M‖∞, m_active, arange)."""
    n = q.shape[1]
    vout = mask[:, :, None] & mask[:, None, :]
    rowsum = torch.where(vout, M, 0.0).abs().sum(dim=2)
    norminf = torch.where(mask, rowsum, 0.0).amax(dim=1)
    m_active = mask.sum(dim=1).to(M.dtype)
    qv = torch.where(mask, q, 1.0)
    Mp = torch.where(vout, M, 0.0) + torch.diag_embed((~mask).to(M.dtype))
    arange = torch.arange(n, device=M.device)[None, :]
    return Mp, qv, norminf, m_active, arange


def _ppm_loop_plain(Mp, qv, valid, ztol, nonbas, z, done, max_piv, arange):
    """The pivot loop of both plain versions, from the nonbasic sets `nonbas`
    with `done` problems frozen. Returns (z, done, pivots (B,), sizes): the
    pivots each problem took and the size of the nonbasic system it solved at
    each of them ((P, B), 0 where the problem had already ended)."""
    B, n = qv.shape
    done = done.clone()
    pivots = torch.zeros(B, dtype=torch.int64, device=qv.device)
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
    sizes = torch.stack(nb_sizes) if nb_sizes else pivots.new_zeros((0, B))
    return z, done, pivots, sizes


def ppm_lcp_plain(M, q, mask, z0=None, max_piv=None, with_pivots=False):
    """`ppm_lcp` in batched PyTorch: the same pivoting, as a loop of masked
    batched iterations that ends when every problem is done or out of
    pivots. Works on any device; nothing on the card's main path calls it.
    `with_pivots` adds the pivots each problem took, (B,) int64, and the size
    of the nonbasic system it solved at each of them, (P, B) int64 with 0
    where the problem had already ended (P: the pivots of the longest)."""
    B, n = q.shape
    if max_piv is None:
        max_piv = 2 * n + 8
    valid = mask
    Mp, qv, norminf, m_active, arange = _problem_plain(M, q, mask)
    ztol = m_active * norminf * cfg.eps(M.dtype)

    start_mask, minq = _first_min(qv, valid, arange, n)
    trivial = minq > -ztol
    nonbas = start_mask & ~trivial[:, None]
    if z0 is not None:
        warm = (z0.abs() >= ztol[:, None]) & valid
        any_warm = warm.any(dim=1)
        nonbas = torch.where(any_warm[:, None], warm, nonbas)

    z, done, pivots, sizes = _ppm_loop_plain(
        Mp, qv, valid, ztol, nonbas, torch.zeros_like(q), trivial, max_piv,
        arange)
    z_out = torch.where(valid & (~trivial & done)[:, None], z, 0.0)
    if with_pivots:
        return z_out, done, pivots, sizes
    return z_out, done


def bpp_lcp(M, q, mask, z0=None, max_bpp=24, max_piv=None):
    """Solve B LCPs by block principal pivoting, then principal pivoting from
    its last basis, then the complementarity check.

    M (B, n, n), q (B, n), mask (B, n) bool, z0 (B, n) or None (cold start)
    -> (z (B, n), ok (B,) bool). `ok` is verified: the problem finished and
    z satisfies z >= -tol, w >= -tol, |z w| <= tol with tol = m·‖M‖∞·sqrt(eps)
    on the active slots, or there was nothing to do (an empty start set,
    which includes an all-false mask). z is zero unless the problem finished.

    A CPU tensor goes to `bpp_lcp_plain`. A CUDA tensor launches the kernel
    on the current stream (no synchronisation) or raises: on a wrong dtype,
    shape or layout, on a problem too large for the block's shared memory
    (`fits`), on a build or launch error. `bpp_lcp.launches` counts the
    kernel launches.
    """
    if M.device.type == "cpu":
        return bpp_lcp_plain(M, q, mask, z0=z0, max_bpp=max_bpp, max_piv=max_piv)
    _, n = _check_inputs("bpp_lcp", M, q, mask, z0)
    if max_piv is None:
        max_piv = 2 * n + 8
    z, ok = _launch("bpp_lcp", M, q, mask, z0, (max_bpp, max_piv))
    if z.numel():
        bpp_lcp.launches += 1
    return z, ok


bpp_lcp.launches = 0


# non-improving block iterations before the least-index fallback: `kBudget`
# in csrc/bpp_lcp.cu
_P_BUDGET = 3


def bpp_lcp_plain(M, q, mask, z0=None, max_bpp=24, max_piv=None,
                  with_pivots=False):
    """`bpp_lcp` in batched PyTorch: the same three stages as loops of masked
    batched iterations. Works on any device; nothing on the card's main path
    calls it. `with_pivots` adds (iters (B,), pivots (B,), sizes (P, B)): the
    block iterations and the PPM pivots each problem took and the size of the
    nonbasic system of every solve it made (block iterations first), 0 where
    the problem had already ended."""
    B, n = q.shape
    dtype = M.dtype
    if max_piv is None:
        max_piv = 2 * n + 8
    valid = mask
    Mp, qv, norminf, m_active, arange = _problem_plain(M, q, mask)
    ztol = m_active * norminf * cfg.eps(dtype)
    check_tol = m_active * norminf * (cfg.eps(dtype) ** 0.5)

    cold = (qv < -ztol[:, None]) & valid
    if z0 is None:
        F = cold
    else:
        warm = (z0.abs() >= ztol[:, None]) & valid
        F = torch.where(warm.any(dim=1)[:, None], warm, cold)
    trivial = ~F.any(dim=1)

    # ---- stage 1: block pivoting
    z = torch.zeros_like(q)
    done = trivial.clone()
    iters = torch.zeros(B, dtype=torch.int64, device=q.device)
    best = torch.full((B,), n + 1, dtype=torch.int64, device=q.device)
    p = torch.full((B,), _P_BUDGET, dtype=torch.int64, device=q.device)
    sizes = []
    for _ in range(max_bpp):
        active = ~done
        if not bool(active.any()):
            break
        steps = torch.nonzero((F & active[:, None]).any(dim=0))[:, 0].tolist()
        z_nb = _solve_masked_plain(Mp, qv, F, steps)
        sizes.append(torch.where(active, F.sum(dim=1), 0))
        bas = valid & ~F
        w = torch.where(bas, (Mp @ z_nb[..., None])[..., 0] + qv, 0.0)
        H1 = F & (z_nb < -ztol[:, None])
        H2 = bas & (w < -ztol[:, None])
        viol = H1 | H2
        ninf = viol.sum(dim=1)
        solved = ninf == 0
        improved = ninf < best
        p_next = torch.where(improved, _P_BUDGET, p - 1)
        first = torch.where(viol, arange, n).amin(dim=1)
        flip = viol & ((p_next > 0)[:, None] | (arange == first[:, None]))
        F_next = (F & ~(flip & H1)) | (flip & H2)
        F = torch.where((active & ~solved)[:, None], F_next, F)
        z = torch.where(active[:, None], z_nb, z)
        done = done | (active & solved)
        best = torch.where(active & improved, ninf, best)
        p = torch.where(active, p_next.clamp_min(0), p)
        iters += active

    # ---- stage 2: principal pivoting from the block stage's last set
    bpp_done = done
    z_ppm, done, pivots, ppm_sizes = _ppm_loop_plain(
        Mp, qv, valid, ztol, F, z, bpp_done, max_piv, arange)
    z_out = torch.where(bpp_done[:, None], z, z_ppm)
    z_out = torch.where(valid & (~trivial & done)[:, None], z_out, 0.0)

    # ---- stage 3: the check (NaN-propagating minima, as jnp.min)
    tol = check_tol
    w_all = torch.where(valid, (Mp @ z_out[..., None])[..., 0] + qv, 0.0)
    zw = z_out * w_all
    ver = ((torch.where(valid, z_out, 0.0).amin(dim=1) >= -tol)
           & (torch.where(valid, w_all, 0.0).amin(dim=1) >= -tol)
           & (torch.where(valid, zw, 0.0).abs().amax(dim=1) <= tol))
    ok = (done & ver) | trivial
    if with_pivots:
        all_sizes = torch.cat(
            [torch.stack(sizes) if sizes else iters.new_zeros((0, B)), ppm_sizes])
        return z_out, ok, iters, pivots, all_sizes
    return z_out, ok
