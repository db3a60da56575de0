#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`moby_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU (sm_90a):

    python3 chip_smoke.py

It needs no network and no JAX. Phases, each of which fails the run:

1. device  — a CUDA device is present; prints its name and power limit.
2. build   — compiles `moby_tpu_torch/csrc/ppm_lcp.cu` with nvcc and loads it.
3. kernels — `hopper_lcp.ppm_lcp` against `hopper_lcp.ppm_lcp_plain` on the
             card, float32 and float64, at the contact step's shapes
             (n=66 and n=6, B=512): monotone and KKT-shaped problems, cold and
             warm, partial masks, an all-false mask, q>0, a singular problem.
             On the stack's own KKT problems, whose z is not unique, the
             contact impulses and the contact-space velocity change they
             cause are compared instead.
4. step    — the full-width contact step: the 3-sphere friction+restitution
             stack (mu=0.5, eps=0.3, nk=16, so the impact LCP has n=66),
             float32, B=512 scenarios with per-scenario height jitter, 50
             steps of dt=1e-3 through `stepper.step`. The kernel's launch
             count is set to 0 just before and read just after.
             Two more steps under torch.profiler then give the device's
             busy share of a step and the launches a step, by kernel name.
5. parity  — the same scene at B=4 for 200 steps: card float32 against the
             port on the CPU in float64.

Then the kernel is timed on the inputs the step phase really gave it, beside
its plain version and its bound. Output: a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device the script exits with a non-zero code and no result.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("device", "build", "kernels", "step", "parity")
BATCH = 512          # scenarios of the full-width step
STEPS = 50           # steps of the full-width run
PARITY_STEPS = 200   # steps of the float32-card against float64-CPU run
SOURCE = "moby_tpu_torch/csrc/ppm_lcp.cu"
REPLACES = "moby_tpu/solvers/pallas_lcp.py:226"   # ppm_lcp_one's pl.pallas_call
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# kernel against plain version: both run the same pivots; the kernel fuses
# multiply-adds and sums M z + q in another order, which moves z by a few
# ulps of its largest entries times the conditioning of the sub-solve
DEVICE = "cuda"
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the stack's own KKT problems: z is not unique (see `check_kkt_case`); the
# contact-space velocity change A·impulse always is (the LCP is monotone),
# and the contact impulse [cn, cs-ncs, ct-nct] is where the Delassus matrix A
# is well conditioned on the active contacts. It is (cond about 44) when only
# the touching pairs are active. Three quarters of the batch also force some
# pairs that do not touch active; their rows repeat those of the touching
# pairs up to the 1e-3 m position noise, A is singular to working precision
# (cond 1e7 to 1e19) and the impulse is not determined. So the velocity
# change is compared on every problem both versions call done, within
# KKT_VELOCITY_TOL; on those with cond(A) <= KKT_WELL_CONDITIONED it and the
# impulse are held to TOL, as z is elsewhere. Tolerances are relative to
# max(1, ‖·‖∞). KKT_VELOCITY_TOL is wider than TOL because each version
# accepts a basis once z and w are feasible within ztol = m·‖M‖∞·eps (3e-4
# in float32, 6e-13 in float64, for these problems), and with A singular two
# bases accepted at ztol may differ in A·impulse by up to
# sqrt(‖A‖·ztol·‖z‖): 0.2 and 1e-5 at worst.
KKT_WELL_CONDITIONED = 1e3
KKT_VELOCITY_TOL = {torch.float32: 1e-2, torch.float64: 1e-8}


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps, warmup=2):
    """Mean milliseconds of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- problems
def monotone(B, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n))
    return (torch.tensor(M, dtype=dtype, device=DEVICE),
            torch.tensor(q, dtype=dtype, device=DEVICE))


def build_stack(device, dtype=None):
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.math import quaternion as quat

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    inertia = sc.sphere_inertia(1.0, 1.0)
    b.add_body("sph1", mass=1.0, inertia=inertia, pos=np.array([0, 0, 1.0]))
    b.add_body("sph2", mass=1.0, inertia=inertia, pos=np.array([0, 0, 3.0]))
    b.add_body("sph3", mass=1.0, inertia=inertia, pos=np.array([0, 0, 5.0]))
    b.add_body("ground", enabled=False)
    for n in ("sph1", "sph2", "sph3"):
        b.add_geom(n, sc.SPHERE, [1.0])
    pq = quat.from_rpy(
        torch.tensor([1.5707963267949, 0, 0], dtype=torch.float64)).numpy()
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    cp = sc.ContactParams(epsilon=0.3, mu_coulomb=0.5, nk=16)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    return b.compile(device=device, dtype=dtype)


def jittered(st, B, seed):
    """B scenarios with the benchmark's per-scenario height jitter (numpy)."""
    dz = np.random.default_rng(seed).uniform(size=(B, st.pos.shape[1])) * 0.01
    st = st.expand(B)
    pos = st.pos.clone()
    pos[:, :, 2] += torch.tensor(dz, dtype=pos.dtype, device=pos.device)
    return st.replace(pos=pos)


def stack_kkt(B, seed, dtype):
    """KKT-shaped LCPs (n=66) from the stack's own `build_qp_lcp`: touching
    spheres with random velocities. The touching pairs are always active;
    in the first quarter of the batch they are the only ones, in the rest a
    random subset of the other pairs is active too."""
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import impact, kinematics

    scene, st = build_stack(DEVICE, dtype)
    rng = np.random.default_rng(seed)
    st = st.expand(B)
    nb = st.pos.shape[1]

    def rnd(scale, shape):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype,
                            device=DEVICE)

    pos = st.pos + rnd(1e-3, (B, nb, 3))
    vel = rnd(0.5, (B, nb, 3))
    vel[:, :, 2] -= 0.5
    vel[:, nb - 1] = 0.0
    omega = rnd(0.5, (B, nb, 3))
    omega[:, nb - 1] = 0.0
    st = st.replace(pos=pos, vel=vel, omega=omega)
    pt = kinematics.compute(scene, st)
    _, con = nph.narrow_phase(scene, pt.pos, pt.quat, torch.inf)
    act = torch.tensor(rng.uniform(size=(B, scene.n_contacts)) < 0.7,
                       device=DEVICE)
    touching = [0, 2, 3]
    act[:, touching] = True
    act[: B // 4] = False
    act[: B // 4, touching] = True
    no_lim = act.new_zeros((B, 0))
    p = impact.assemble_problem(scene, st, pt, con, act, no_lim)
    M, q, mask = impact.build_qp_lcp(scene, p, act, no_lim)
    return scene, p.A, M.contiguous(), q.contiguous(), mask


# ------------------------------------------------------------------ phases
def phase_build():
    from moby_tpu_torch.solvers import hopper_lcp

    t0 = time.time()
    path = hopper_lcp.build(force=True)
    hopper_lcp._load()
    log(f"[build] nvcc -> {path} in {time.time() - t0:.1f} s")
    for line in hopper_lcp.build_log.splitlines():
        if "registers" in line or "error" in line.lower() or "spill" in line:
            log(f"[build] {line.strip()}")


def both_versions(name, M, q, mask, z0, verify=True):
    """Kernel and plain version on one batch: (zk, dk, zp, dp, pivots), after
    checking that the kernel's z is finite and (with `verify`) that every
    problem either version calls done satisfies complementarity."""
    from moby_tpu_torch.solvers import hopper_lcp, lcp

    zk, dk = hopper_lcp.ppm_lcp(M, q, mask, z0=z0)
    torch.cuda.synchronize()
    zp, dp, piv, _ = hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0, with_pivots=True)
    torch.cuda.synchronize()
    assert torch.isfinite(zk).all(), f"{name}: kernel returned non-finite z"
    if verify:
        Mp, qp = lcp.pad_lcp(M, q, mask)
        tol = lcp._check_tol(Mp, mask)
        for who, z, d in (("kernel", zk, dk), ("plain", zp, dp)):
            bad = int((d & ~lcp._verify(Mp, qp, z, mask, tol)).sum())
            assert bad == 0, f"{name}: {bad} problems {who} calls done fail complementarity"
    return zk, dk, zp, dp, piv


def check_kkt_case(name, scene, A, M, q, mask, z0):
    """Kernel against plain version on the stack's own KKT problems.

    These are monotone but not strictly: friction variables come in +/- pairs
    with mirrored columns, so first-minimum selection meets exact ties that
    rounding decides, z is not unique, and a chain that ends in `done` in one
    version can run into the pivot cap in the other. What is unique is the
    velocity change the impulses cause, and the impulses themselves where
    the active contacts determine them. So: every problem either version
    calls done satisfies complementarity; the two agree on `done` for at
    least 85% of the batch; where both are done A·impulse agrees within
    KKT_VELOCITY_TOL, and on the well-conditioned ones of those A·impulse and
    the impulses agree within TOL. Returns (velocity error, impulse error).
    """
    from moby_tpu_torch.sim import impact

    dtype = M.dtype
    zk, dk, zp, dp, _ = both_versions(name, M, q, mask, z0)
    n_diff = int((dk != dp).sum())
    assert n_diff <= 0.15 * len(dk), (
        f"{name}: done differs on {n_diff} of {len(dk)} problems")
    both = dk & dp
    assert int(both.sum()) >= 0.3 * len(dk), f"{name}: too few problems done in both"
    ik = impact._impulse_vec(scene, zk)[both]
    ip = impact._impulse_vec(scene, zp)[both]
    Ab = A[both]
    vk = (Ab @ ik[..., None])[..., 0]
    vp = (Ab @ ip[..., None])[..., 0]
    v_diff = (vk - vp).abs().amax(dim=1)
    v_err, v_scale = float(v_diff.max()), max(1.0, float(vp.abs().max()))
    # how well the active contacts determine the impulse (read in float64)
    idle = Ab.diagonal(dim1=1, dim2=2) == 0
    cond = torch.linalg.cond(Ab.double() + torch.diag_embed(idle.double()))
    well = cond <= KKT_WELL_CONDITIONED
    assert int(well.sum()) >= 0.1 * len(dk), f"{name}: too few well-conditioned problems"
    i_diff = (ik - ip).abs().amax(dim=1)
    i_err, i_scale = float(i_diff[well].max()), max(1.0, float(ip[well].abs().max()))
    i_rest = float(i_diff[~well].max()) if bool((~well).any()) else 0.0
    log(f"[kernels] {name:34s} {str(dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
        f"done kernel={int(dk.sum())} plain={int(dp.sum())} differ={n_diff} "
        f"both={int(both.sum())}: A·impulse err={v_err:.3e} (scale {v_scale:.3g}; "
        f"{float(v_diff[well].max()):.3e} on the well-conditioned); "
        f"impulse err={i_err:.3e} (scale {i_scale:.3g}) on the {int(well.sum())} "
        f"with cond(A)<={KKT_WELL_CONDITIONED:.0e}, {i_rest:.3e} on the other "
        f"{int((~well).sum())} (cond median {float(cond[~well].median()) if bool((~well).any()) else 0:.1e}, "
        f"not compared)")
    assert v_err <= KKT_VELOCITY_TOL[dtype] * v_scale, (
        f"{name}: contact-space velocity change differs by {v_err:.3e}")
    assert float(v_diff[well].max()) <= TOL[dtype] * v_scale, (
        f"{name}: contact-space velocity change differs by "
        f"{float(v_diff[well].max()):.3e} where A is well conditioned")
    assert i_err <= TOL[dtype] * i_scale, (
        f"{name}: impulses differ by {i_err:.3e} where A is well conditioned")
    return v_err, i_err


def check_case(name, M, q, mask, z0, verify=True):
    """Kernel against plain version on one batch: equal `done`, z within TOL,
    complementarity of what is done. Returns (max_abs_err, n_done, pivots)."""
    dtype = M.dtype
    zk, dk, zp, dp, piv = both_versions(name, M, q, mask, z0, verify)
    n_diff = int((dk != dp).sum())
    assert n_diff == 0, f"{name}: done differs on {n_diff} of {len(dk)} problems"
    scale = max(1.0, float(zp.abs().max()))
    err = float((zk - zp).abs().max())
    assert err <= TOL[dtype] * scale, (
        f"{name}: max|z_kernel - z_plain| = {err:.3e} > {TOL[dtype]:.0e}*{scale:.3g}")
    log(f"[kernels] {name:34s} {str(dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
        f"done={int(dk.sum())}/{len(dk)} pivots={int(piv.sum())} "
        f"max_abs_err={err:.3e}")
    return err, int(dk.sum()), piv


def phase_kernels():
    from moby_tpu_torch.solvers.hopper_lcp import ppm_lcp_plain

    worst = 0.0
    B = BATCH
    for dtype in (torch.float32, torch.float64):
        for n in (66, 6):
            M, q = monotone(B, n, 1, dtype)
            full = torch.ones(B, n, dtype=torch.bool, device=DEVICE)
            e, nd, _ = check_case(f"monotone n={n} cold", M, q, full, None)
            assert nd == B
            worst = max(worst, e)
            rng = np.random.default_rng(2)
            part = torch.tensor(rng.uniform(size=(B, n)) < 0.7, device=DEVICE)
            part[0] = False
            zc, _ = ppm_lcp_plain(M, q, part)
            z0 = zc * torch.tensor(rng.uniform(0.5, 1.5, size=(B, n)),
                                   dtype=dtype, device=DEVICE)
            z0[1::2] = torch.tensor(np.abs(rng.normal(size=(B // 2, n))),
                                    dtype=dtype, device=DEVICE)
            e, nd, _ = check_case(f"monotone n={n} warm partial mask", M, q,
                                  part, z0)
            assert nd == B
            worst = max(worst, e)
            none = torch.zeros_like(full)
            e, nd, piv = check_case(f"all-false mask n={n}", M, q, none, z0)
            assert nd == B and e == 0.0 and int(piv.sum()) == 0
            e, nd, piv = check_case(f"q>0 n={n}", M, q.abs() + 0.1, full, None)
            assert nd == B and e == 0.0 and int(piv.sum()) == 0
            Ms, qs = M.clone(), q.clone()
            Ms[:, 2, :] = 0.0
            Ms[:, :, 2] = 0.0
            qs[:, 2] = -1.0
            e, _, _ = check_case(f"singular (zero row/col) n={n}", Ms, qs, full,
                                 None, verify=False)
            worst = max(worst, e)
        scene, Ak, Mk, qk, mk = stack_kkt(B, 3, dtype)
        check_kkt_case("stack KKT n=66 cold", scene, Ak, Mk, qk, mk, None)
        zc, _ = ppm_lcp_plain(Mk, qk, mk)
        check_kkt_case("stack KKT n=66 warm", scene, Ak, Mk, qk, mk,
                       zc.contiguous())
        # the same problems made strictly monotone (+0.05·I on the active
        # block): the solution is unique, so z is compared again
        Mr = (Mk + 0.05 * torch.diag_embed(mk.to(dtype))).contiguous()
        e, nd, _ = check_case("stack KKT + 0.05 I n=66 cold", Mr, qk, mk, None)
        assert nd == B
        worst = max(worst, e)
    return worst


def phase_step():
    """The main path: BATCH scenarios of the stack through `stepper.step`."""
    from moby_tpu_torch.sim import stepper
    from moby_tpu_torch.solvers import hopper_lcp

    B, n_steps = BATCH, STEPS
    scene, st = build_stack(DEVICE)
    assert st.pos.dtype == torch.float32 and scene.n_lcp == 66
    st = jittered(st, B, 0)
    order0 = torch.argsort(st.pos[:, :3, 2], dim=1)

    # keep what the main path hands the kernel, so that the kernel can
    # afterwards be timed on those inputs
    recorded = []
    wrapper = hopper_lcp.ppm_lcp

    def recording(M, q, mask, z0=None, max_piv=None):
        recorded.append((M, q, mask, z0))
        return wrapper(M, q, mask, z0=z0, max_piv=max_piv)

    stepper.step(scene, st, 1e-3, device=DEVICE)   # warm-up step, not counted
    torch.cuda.synchronize()
    # the wrapper counts on the function that `hopper_lcp.ppm_lcp` names, so
    # the stand-in carries the count while it is in place
    hopper_lcp.ppm_lcp = recording
    recording.launches = 0
    piv_total = torch.zeros((), dtype=torch.int64, device=DEVICE)
    solved_steps = torch.zeros((), dtype=torch.int64, device=DEVICE)
    t0 = time.time()
    for _ in range(n_steps):
        st = stepper.step(scene, st, 1e-3, device=DEVICE)
        piv_total += st.solver_pivots.sum()
        solved_steps += (st.solver_pivots > 0).sum()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = recording.launches
    hopper_lcp.ppm_lcp = wrapper

    for name in ("pos", "quat", "vel", "omega", "zlast"):
        assert torch.isfinite(getattr(st, name)).all(), f"step: {name} not finite"
    z = st.pos[:, :3, 2]
    lowest = float((z[:, 0] - st.pos[:, 3, 2] - 1.0).min())   # above its own ground
    assert lowest > -5e-3, f"step: a sphere is {-lowest:.3e} m below the plane"
    assert bool((torch.argsort(z, dim=1) == order0).all()), "step: stack order lost"
    gaps = z[:, 1:] - z[:, :-1]
    assert float(gaps.min()) > 2.0 - 5e-3, "step: spheres interpenetrate"
    assert launches >= 2 * n_steps, (
        f"step: {launches} kernel launches in {n_steps} steps, expected >= 2 a step")
    assert len(recorded) == launches
    nonempty = sum(int(m.any(dim=1).sum()) for (_, _, m, _) in recorded)
    total = sum(m.shape[0] for (_, _, m, _) in recorded)
    log(f"[step] B={B} steps={n_steps} dt=1e-3 float32: {elapsed:.2f} s, "
        f"{B * n_steps / elapsed:.1f} scenario-steps/s, {n_steps / elapsed:.2f} batch-steps/s")
    log(f"[step] ppm_lcp launches={launches} ({launches / n_steps:.2f} a step); "
        f"problems handed to the kernel={total}, with a non-empty mask={nonempty}")
    log(f"[step] lowest sphere bottom {lowest:+.3e} m, min gap {float(gaps.min()) - 2.0:+.3e} m, "
        f"scenario-steps with an impact solve {int(solved_steps)} of {B * n_steps} "
        f"({int(piv_total)} BPP iterations in all)")
    assert int(solved_steps) > 0, "step: no impact was ever solved"
    device_share(lambda: stepper.step(scene, st, 1e-3, device=DEVICE),
                 elapsed / n_steps)
    return launches, recorded, B * n_steps / elapsed


def device_share(step_fn, step_seconds, n_steps=2):
    """Where a step's time goes: the device time of `n_steps` more steps by
    kernel name (torch.profiler), against the unprofiled step time measured
    just before. A reading, not a check: prints "not measured" if the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step_fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages() if ev.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / n_steps / 1e6
    if busy <= 0:
        log("[step] device time per step: not measured (profiler saw no kernel)")
        return
    n_kernels = sum(r[2] for r in rows) / n_steps
    log(f"[step] device busy {busy * 1e3:.2f} ms of a {step_seconds * 1e3:.2f} ms step "
        f"(idle share {1.0 - busy / step_seconds:.3f}), {n_kernels:.0f} kernel launches a step")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[step]   {us / n_steps / 1e3:8.3f} ms/step {count / n_steps:8.0f} launches/step  {key[:90]}")


def phase_parity():
    """Card float32 against the port on the CPU in float64 (plain cascade)."""
    from moby_tpu_torch.sim import stepper

    B, n_steps = 4, PARITY_STEPS
    scene32, st32 = build_stack(DEVICE)
    scene64, st64 = build_stack("cpu")
    assert st64.pos.dtype == torch.float64
    st32, st64 = jittered(st32, B, 7), jittered(st64, B, 7)
    _, (p32, _, _) = stepper.rollout(scene32, st32, 1e-3, n_steps, device=DEVICE)
    _, (p64, _, _) = stepper.rollout(scene64, st64, 1e-3, n_steps, device="cpu")
    p32 = p32.double().cpu()[:, :, :3]
    p64 = p64[:, :, :3]
    drift = float((p32 - p64).abs().max())
    z_drift = float((p32[-1, :, :, 2] - p64[-1, :, :, 2]).abs().max())
    same_order = bool((torch.argsort(p32[-1, :, :, 2], dim=1)
                       == torch.argsort(p64[-1, :, :, 2], dim=1)).all())
    log(f"[parity] B={B} steps={n_steps}: max drift {drift:.3e} m, final height "
        f"drift {z_drift:.3e} m, same order {same_order}")
    assert torch.isfinite(p32).all()
    assert drift < 5e-2, f"parity: float32 drift {drift:.3e} m"
    assert z_drift < 5e-3, f"parity: float32 height drift {z_drift:.3e} m"
    assert same_order, "parity: stack order differs"
    return drift


def bound_ms(M, mask, z0, pivots, nb_sizes):
    """The least time the card could take for one float32 call on these
    inputs: the larger of bytes over the memory rate and operations over the
    float32 rate.

    Bytes: mask read, z and done written for every problem; the active block
    of M and of q only for a problem with a non-empty mask (an empty one is
    decided by its mask), z0 only for one that pivots. Operations: for every
    pivot taken (`pivots` (B,), `nb_sizes` (P, B) from `ppm_lcp_plain`), a
    solve of the k nonbasic unknowns, (2/3)·k³, and w = M z + q over the m
    active rows, 2·m·k. Returns (ms, "bytes" or "operations")."""
    assert M.dtype == torch.float32
    B, n, _ = M.shape
    el = M.element_size()
    m = mask.sum(dim=1).double()
    nbytes = B * (n + n * el + 1) + el * float((m * m + m).sum())
    if z0 is not None:
        nbytes += el * float(m[pivots > 0].sum())
    k = nb_sizes.double()
    flops = float(((2.0 / 3.0) * k ** 3 + 2.0 * m[None, :] * k).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, reps=20):
    """Mean device time of the PPM kernel alone over `reps` calls of fn, from
    torch.profiler's kernel records (the wrapper's host work and its mask
    conversion are left out); None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "ppm_lcp_kernel" in ev.key:
            total_us = getattr(ev, "device_time_total", None)
            if total_us is None:
                total_us = ev.cuda_time_total
            if total_us > 0 and ev.count > 0:
                return total_us / ev.count / 1e3
    return None


def measure_kernel(recorded, launches, max_err):
    """Time the kernel on the inputs the main path gave it (up to 48 of the
    recorded calls, evenly spaced), beside the plain version and the bound."""
    from moby_tpu_torch.solvers import hopper_lcp

    picks = recorded[:: max(1, len(recorded) // 48)][:48]
    ms = plain_ms = bnd = 0.0
    by = {"bytes": 0, "operations": 0}
    shapes = {}
    for (M, q, mask, z0) in picks:
        _, _, piv, sizes = hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0,
                                                    with_pivots=True)
        ms += time_cuda(lambda: hopper_lcp.ppm_lcp(M, q, mask, z0=z0), 20)
        plain_ms += time_cuda(
            lambda: hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0), 3, warmup=1)
        b, which = bound_ms(M, mask, z0, piv, sizes)
        bnd += b
        by[which] += 1
        key = f"B={M.shape[0]} n={M.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
    k = len(picks)
    M0, q0, mask0, z00 = next(r for r in picks if r[0].shape[1] == 66)
    main_dev = device_ms(lambda: hopper_lcp.ppm_lcp(M0, q0, mask0, z0=z00))
    # the same kernel doing real work: every problem of a B=512, n=66
    # monotone batch pivots to its solution (float32, cold)
    M, q = monotone(BATCH, 66, 1, torch.float32)
    full = torch.ones(BATCH, 66, dtype=torch.bool, device=DEVICE)
    _, _, piv, sizes = hopper_lcp.ppm_lcp_plain(M, q, full, with_pivots=True)
    work_ms = time_cuda(lambda: hopper_lcp.ppm_lcp(M, q, full), 10)
    work_plain = time_cuda(lambda: hopper_lcp.ppm_lcp_plain(M, q, full), 1, warmup=0)
    wb, wwhich = bound_ms(M, full, None, piv, sizes)
    work_dev = device_ms(lambda: hopper_lcp.ppm_lcp(M, q, full), reps=5)
    return {
        "name": "ppm_lcp", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms / k, "plain_ms": plain_ms / k, "bound_ms": bnd / k,
        "bound_by": max(by, key=by.get),
        # no single PyTorch call computes an LCP
        "library_ms": None,
        # ms is the wrapper call as the main path pays for it (host work,
        # mask conversion and launch); device_ms is the kernel alone on one of
        # the main path's n=66 calls, from the profiler
        "device_ms": main_dev,
        "timed_on": f"{k} of the main path's {len(recorded)} calls", "shapes": shapes,
        "full_work_case": {
            "shape": "B=512 n=66 float32 monotone, full mask, cold",
            "pivots": int(piv.sum()),
            "mean_nonbasic": float(sizes.sum()) / max(1, int(piv.sum())),
            "ms": work_ms, "device_ms": work_dev,
            "plain_ms": work_plain,
            "bound_ms": wb, "bound_by": wwhich,
        },
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import moby_tpu_torch  # noqa: F401  (fails here if the package is absent)

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase_build()          # every later phase needs the library
    max_err = phase_kernels() if "kernels" in phases else None
    launches, recorded, rate = (phase_step() if "step" in phases
                                else (0, [], None))
    if "parity" in phases:
        phase_parity()
    full_run = set(phases) == set(PHASES)
    if recorded:
        entry = measure_kernel(recorded, launches, max_err)
        log(json.dumps({"kernels": [entry]}))
    log(f"[done] {time.time() - t_start:.1f} s; scenario-steps/s at B={BATCH}: {rate}")
    log(card)
    if not full_run:
        log(f"partial run (phases: {phases}): no result line")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
