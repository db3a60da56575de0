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
device code in `csrc/lcp_common.cuh`), float and double, built by `nvcc` for
sm_90a at first use into ``moby_tpu_torch/build/`` (one `nvcc` per source,
started together) and loaded with `ctypes`; importing this module builds and
loads nothing.

What bounds them on the card is the serial depth of the pivot chain, not
bytes or operations. `launch_plan` picks one of two paths from n and the
dtype alone (no option, no fallback on failure):

* n <= 32, the group path: a problem is a group of G lanes of one warp (G
  the smallest of 8, 16, 32 that is >= n), lane i holds row i of the system
  in registers, eliminations broadcast rows with warp shuffles and the index
  sets are G-bit masks; no block barrier anywhere. Two warps a block.
* n > 32, the block path: one block of 256 threads per problem, the whole
  problem in shared memory. The PPM pivot loop keeps the principal pivot
  transform (Tucker's tableau) of [M | q] for the current nonbasic set and
  updates it by one rank-one update per entering or leaving index; it
  re-solves from M every `_REFRESH` updates, before it returns done, and
  on a pivot of magnitude <= 1e-30. The block stage of `bpp_lcp`
  re-solves each iteration with a one-barrier-per-step Gauss–Jordan.

See the notes at the head of the CUDA sources. `_ppm_tableau_plain` is the
block path's pivot loop in batched PyTorch, for the tests.

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

A caller's `check_tol` (B,) replaces the check's own tolerance, and then an
empty start set is checked too (z = 0, so w = M·0 + q): `ok` is exactly
"batched `lcp_bpp`, then `_verify` at `check_tol`", and a NaN in M or in
`check_tol` gives ok=0. An all-false mask stays ok=1, as `_verify` over an
empty mask does. Without it the Pallas body's semantics above hold.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import NamedTuple

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


# group widths of the n <= 32 path and the threads of one of its blocks:
# `kGroupThreads` in csrc/lcp_common.cuh
GROUP_WIDTHS = (8, 16, 32)
GROUP_THREADS = 64
# tableau updates of the n > 32 PPM pivot loop between two re-solves from M:
# `kRefresh`
_REFRESH = 16


class LaunchPlan(NamedTuple):
    """How a batch of B problems of size n is launched.

    path: "group" (n <= 32: G lanes of a warp per problem) or "block" (one
    block per problem, 256 threads); group: G, 0 on the block path;
    per_block: problems a block holds; grid: blocks; smem: dynamic shared
    memory of a block in bytes."""

    path: str
    group: int
    per_block: int
    grid: int
    smem: int


def launch_plan(n: int, dtype, B: int) -> LaunchPlan:
    """The launch of both kernels, chosen from n and the dtype alone. The
    wrappers pass these values to the kernels, which check them."""
    n = int(n)
    if n <= GROUP_WIDTHS[-1]:
        g = next(w for w in GROUP_WIDTHS if w >= n)
        per_block = GROUP_THREADS // g
        return LaunchPlan("group", g, per_block, -(-int(B) // per_block), 0)
    return LaunchPlan("block", 0, 1, int(B), smem_bytes(n, dtype))


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
            # ppm: (M, q, mask, z0, z, ok, B, n, np, max_piv, group,
            # per_block, grid, smem, stream); bpp has the check tolerance
            # after z0 and max_bpp before max_piv
            n_ptr, n_int = (6, 8) if name == "ppm_lcp" else (7, 9)
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
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


def _check_inputs(who, M, q, mask, z0, check_tol=None):
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
    if check_tol is not None:
        if tuple(check_tol.shape) != (B,):
            raise ValueError(
                f"{who}: check_tol must be ({B},), got {tuple(check_tol.shape)}")
        if check_tol.device != M.device or check_tol.dtype != M.dtype:
            raise TypeError(f"{who}: check_tol must be {M.dtype} on {M.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{who}: mask must be bool, got {mask.dtype}")
    for name, t in (("M", M), ("q", q), ("mask", mask), ("z0", z0),
                    ("check_tol", check_tol)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if not fits(n, M.dtype):
        raise ValueError(
            f"{who}: n={n} in {M.dtype} needs {smem_bytes(n, M.dtype)} bytes "
            f"of shared memory, a block has {SMEM_LIMIT_BYTES}")
    return B, n


def _launch(who, M, q, mask, z0, ints, tol=()):
    """Launch kernel `who` on the current stream with the plan of
    `launch_plan`; `tol` is () for ppm_lcp, (check_tol or None,) for
    bpp_lcp. Returns (z, ok)."""
    B, n = q.shape
    lib = _load()[who]
    z = torch.empty_like(q)
    # mask and ok cross as torch.bool: one byte each, 0 or 1
    ok = torch.empty(B, dtype=torch.bool, device=M.device)
    if B == 0 or n == 0:
        return z.zero_(), ok.fill_(True)
    fn = getattr(lib, who + ("_f32" if M.dtype == torch.float32 else "_f64"))
    plan = launch_plan(n, M.dtype, B)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(M.data_ptr(), q.data_ptr(), mask.data_ptr(),
                None if z0 is None else z0.data_ptr(),
                *(None if t is None else t.data_ptr() for t in tol),
                z.data_ptr(), ok.data_ptr(), B, n, padded_size(n),
                *(int(i) for i in ints), plan.group, plan.per_block,
                plan.grid, plan.smem, stream)
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


def _principal_pivot_plain(T, r, do):
    """One principal pivot of the tableaux T (B, n, n+1) on index r (B,),
    where `do`: T_rr -> 1/T_rr, row r -> -T_rj/T_rr, column r -> T_ir/T_rr,
    the rest T_ij - T_ir·(T_rj/T_rr). Returns (T, tiny): where |T_rr| <=
    1e-30 the tableau stays as it was and `tiny` is set."""
    B = T.shape[0]
    b = torch.arange(B, device=T.device)
    row = T[b, r, :]
    col = T[b, :, r]
    p = row[b, r]
    tiny = do & ~(p.abs() > 1e-30)
    go = do & ~tiny
    inv = 1.0 / torch.where(go, p, 1.0)
    rowp = -(row * inv[:, None])
    new = T + col[:, :, None] * rowp[:, None, :]
    new[b, r, :] = rowp
    new[b, :, r] = col * inv[:, None]
    new[b, r, r] = inv
    return torch.where(go[:, None, None], new, T), tiny


def _build_tableau_plain(Mp, qv, nonbas, do):
    """The principal pivot transform of [Mp | qv] on the nonbasic set, one
    pivot per index in ascending order, where `do`. Returns (T, built):
    `built` is False where a pivot was tiny (the build stops there)."""
    B, n = qv.shape
    T = torch.cat([Mp, qv[:, :, None]], dim=2)
    built = do.clone()
    for k in range(n):
        sel = built & nonbas[:, k]
        if bool(sel.any()):
            T, tiny = _principal_pivot_plain(
                T, torch.full((B,), k, device=T.device), sel)
            built = built & ~tiny
    return T, built


def _resolve_plain(Mp, qv, valid, nonbas, sel):
    """z and w = Mp z + qv (on the basic rows) of a fresh solve from Mp."""
    steps = torch.nonzero((nonbas & sel[:, None]).any(dim=0))[:, 0].tolist()
    z = _solve_masked_plain(Mp, qv, nonbas, steps)
    bas = valid & ~nonbas
    return z, torch.where(bas, (Mp @ z[..., None])[..., 0] + qv, 0.0)


def _ppm_decide(z, w, nonbas, bas, ztol, arange):
    """One pivot rule step: (solved, next nonbasic set)."""
    n = z.shape[1]
    wmask, minw = _first_min(w, bas, arange, n)
    zmask, minz = _first_min(z, nonbas, arange, n)
    w_ok = minw > -ztol
    z_neg = minz < -ztol
    nonbas2 = (nonbas | (wmask & ~w_ok[:, None])) & ~(zmask & z_neg[:, None])
    return w_ok & ~z_neg, nonbas2


def _ppm_tableau_plain(M, q, mask, z0=None, max_piv=None, refresh=_REFRESH):
    """The pivot loop of the n > 32 path of both kernels, in batched
    PyTorch, from `ppm_lcp`'s start: the same pivot rule as
    `ppm_lcp_plain`, but z_F and w_B are read from the tableau of [M | q] on
    the current nonbasic set, which each entering or leaving index updates
    by one principal pivot. It is rebuilt from M when it is missing or has
    taken `refresh` updates, and after a pivot whose magnitude is <= 1e-30
    (a build that meets one falls back to `ppm_lcp_plain`'s Gauss–Jordan
    for that iteration); a "solved" read from an updated tableau is checked
    again on a fresh solve. For the tests only: nothing calls it.

    -> (z, done, pivots (B,), stats): stats counts, over the batch, the
    tableau builds, the builds that met a tiny pivot, the rank-one updates
    and the fresh re-checks of a "solved"."""
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
        nonbas = torch.where(warm.any(dim=1)[:, None], warm, nonbas)

    T = torch.zeros(B, n, n + 1, dtype=M.dtype, device=M.device)
    tab_ok = torch.zeros(B, dtype=torch.bool, device=M.device)
    since = torch.zeros(B, dtype=torch.int64, device=M.device)
    z = torch.zeros_like(q)
    done = trivial.clone()
    pivots = torch.zeros(B, dtype=torch.int64, device=M.device)
    stats = {"builds": 0, "tiny_builds": 0, "updates": 0, "rechecks": 0}
    for _ in range(max_piv):
        active = ~done
        if not bool(active.any()):
            break
        need = active & (~tab_ok | (since >= refresh))
        if bool(need.any()):
            Tn, built = _build_tableau_plain(Mp, qv, nonbas, need)
            T = torch.where(need[:, None, None], Tn, T)
            tab_ok = torch.where(need, built, tab_ok)
            since = torch.where(need, 0, since)
            stats["builds"] += int(need.sum())
            stats["tiny_builds"] += int((need & ~built).sum())
        bas = valid & ~nonbas
        t = T[:, :, n]
        zc = torch.where(nonbas, t, 0.0)
        wc = torch.where(bas, t, 0.0)
        gj = active & ~tab_ok
        if bool(gj.any()):
            zg, wg = _resolve_plain(Mp, qv, valid, nonbas, gj)
            zc = torch.where(gj[:, None], zg, zc)
            wc = torch.where(gj[:, None], wg, wc)
        solved, nonbas2 = _ppm_decide(zc, wc, nonbas, bas, ztol, arange)
        recheck = active & solved & ~need
        if bool(recheck.any()):
            stats["rechecks"] += int(recheck.sum())
            zg, wg = _resolve_plain(Mp, qv, valid, nonbas, recheck)
            solved_f, nonbas2_f = _ppm_decide(zg, wg, nonbas, bas, ztol, arange)
            zc = torch.where(recheck[:, None], zg, zc)
            solved = torch.where(recheck, solved_f, solved)
            nonbas2 = torch.where(recheck[:, None], nonbas2_f, nonbas2)
            # the fresh check disagreed: pivot on from a rebuilt tableau
            tab_ok = tab_ok & ~(recheck & ~solved_f)
        upd = active & ~solved
        ut = upd & tab_ok
        for idx in (nonbas2 & ~nonbas, nonbas & ~nonbas2):   # enter, then leave
            has = ut & idx.any(dim=1)
            if bool(has.any()):
                T, tiny = _principal_pivot_plain(T, idx.to(torch.int8).argmax(dim=1), has)
                stats["updates"] += int((has & ~tiny).sum())
                since = since + (has & ~tiny)
                tab_ok = tab_ok & ~tiny
                ut = ut & ~tiny
        nonbas = torch.where(upd[:, None], nonbas2, nonbas)
        z = torch.where(active[:, None], zc, z)
        done = done | (active & solved)
        pivots += active
    z_out = torch.where(valid & (~trivial & done)[:, None], z, 0.0)
    return z_out, done, pivots, stats


def bpp_lcp(M, q, mask, z0=None, max_bpp=24, max_piv=None, check_tol=None):
    """Solve B LCPs by block principal pivoting, then principal pivoting from
    its last basis, then the complementarity check.

    M (B, n, n), q (B, n), mask (B, n) bool, z0 (B, n) or None (cold start),
    check_tol (B,) of M's dtype or None -> (z (B, n), ok (B,) bool). `ok` is
    verified: the problem finished and z satisfies z >= -tol, w >= -tol,
    |z w| <= tol on the active slots, or there was nothing to do (an empty
    start set, which includes an all-false mask). tol is `check_tol` where
    given, else m·‖M‖∞·sqrt(eps); with `check_tol` an empty start set is
    checked too (z = 0), and only an all-false mask is ok unchecked. z is
    zero unless the problem finished.

    A CPU tensor goes to `bpp_lcp_plain`. A CUDA tensor launches the kernel
    on the current stream (no synchronisation) or raises: on a wrong dtype,
    shape or layout, on a problem too large for the block's shared memory
    (`fits`), on a build or launch error. `bpp_lcp.launches` counts the
    kernel launches.
    """
    if M.device.type == "cpu":
        return bpp_lcp_plain(M, q, mask, z0=z0, max_bpp=max_bpp, max_piv=max_piv,
                             check_tol=check_tol)
    _, n = _check_inputs("bpp_lcp", M, q, mask, z0, check_tol)
    if max_piv is None:
        max_piv = 2 * n + 8
    z, ok = _launch("bpp_lcp", M, q, mask, z0, (max_bpp, max_piv), (check_tol,))
    if z.numel():
        bpp_lcp.launches += 1
    return z, ok


bpp_lcp.launches = 0


# non-improving block iterations before the least-index fallback: `kBudget`
# in csrc/bpp_lcp.cu
_P_BUDGET = 3


def bpp_lcp_plain(M, q, mask, z0=None, max_bpp=24, max_piv=None,
                  check_tol=None, with_pivots=False):
    """`bpp_lcp` in batched PyTorch, `check_tol` included: the same three
    stages as loops of masked batched iterations. Works on any device; nothing on the card's main path
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
    auto_tol = m_active * norminf * (cfg.eps(dtype) ** 0.5)

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
    tol = auto_tol if check_tol is None else check_tol
    w_all = torch.where(valid, (Mp @ z_out[..., None])[..., 0] + qv, 0.0)
    zw = z_out * w_all
    ver = ((torch.where(valid, z_out, 0.0).amin(dim=1) >= -tol)
           & (torch.where(valid, w_all, 0.0).amin(dim=1) >= -tol)
           & (torch.where(valid, zw, 0.0).abs().amax(dim=1) <= tol))
    if check_tol is None:
        ok = (done & ver) | trivial
    else:
        # the empty start set is checked too (z = 0); an all-false mask is ok
        ok = ((done | trivial) & ver) | ~valid.any(dim=1)
    if with_pivots:
        all_sizes = torch.cat(
            [torch.stack(sizes) if sizes else iters.new_zeros((0, B)), ppm_sizes])
        return z_out, ok, iters, pivots, all_sizes
    return z_out, ok
