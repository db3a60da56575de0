#!/usr/bin/env python3
"""Float32 readings of the port's geometry configurations, on the CPU (no
card needed): what `chip_smoke.py`'s geometryparity limits and the float32
notes in ROADMAP.md rest on.

    python scripts/geometry_float32.py drift    # ~1 min
    python scripts/geometry_float32.py freeze   # ~1 min
    python scripts/geometry_float32.py mesh     # ~2 min
    python scripts/geometry_float32.py meshlcp  # ~3 min

`drift`: for each of `chip_smoke.py`'s geometry configurations (curved,
octastack, platforms), B=4 scenarios from seed 1 stepped GEOM_PARITY_STEPS
times at dt=1e-3 by the port on the CPU in float32 and in float64; prints
the largest position difference, whose five-fold is `GEOM_DRIFT_LIMIT`.

`freeze`: the platforms configuration with the 1 kg bodies of the JAX
package's tests instead of 1 t ones, in float32: the impact LCP's norm
‖M‖∞ over the active rows, its tolerance m·‖M‖∞·eps (below which
`lcp_bpp` starts from z = 0 and accepts it) against NEAR_ZERO, and the
simulated time after each of 12 steps (it stops advancing once an approach
slower than the tolerance meets a touching pair: the CA bound is 0 and the
impact does nothing).

`mesh`: for each of `chip_smoke.py`'s mesh configurations (meshes,
meshstack, meshplatforms, meshslabs, bigmesh), B=4 scenarios from seed 1
stepped MESH_PARITY_STEPS times in float64 and in float32, by the JAX package
(which this mode imports; the other modes do not) and by the port: the largest
position difference (five times it is `MESH_DRIFT_LIMIT`); and at every
float64 state along the way the narrow phase in both dtypes (the state cast
to float32), at the CA loop's touch band 4·NEAR_ZERO of float32: active
slots in each, the float32 slots `_dedup_points` kept although their point
lies within 1e-6 m of an earlier active slot of the same pair (duplicate
contacts), slots active in one dtype only, and the largest difference of
the normals of slots active in both (the normals chosen for resting
vertices).

`meshlcp`: for each mesh configuration, B=32 scenarios from seed 0 stepped
twice by the port in CPU float32 through the card's solve cascade
(`cascade="accel"`, `ppm_lcp_plain` in the kernel's place), and for each
LCP origin (the impact QP, stabilization): the problems with work, those
batched BPP verified, those `ppm_lcp_plain` called done among the rest, the
done ones that fail `_verify`'s complementarity check, and those left to the
plain cascade, which on the card runs one host synchronisation per pivot;
and the seconds a step took.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def drift():
    for name in cs.GEOMETRY_SCENES:
        p64 = cs.geometry_parity_run(name, "cpu", 1)
        p32 = cs.geometry_parity_run(name, "cpu", 1, torch.float32)
        d = float((p64 - p32).abs().max())
        print(f"{name}: B={cs.GEOM_PARITY_BATCH} steps={cs.GEOM_PARITY_STEPS[name]} "
              f"CPU float32 against CPU float64: max position drift {d:.3e} "
              f"(5x: {5 * d:.3e})", flush=True)


def freeze():
    from moby_tpu_torch import config as cfg
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import impact, kinematics, stepper

    mass = cs.GEOM_MASS
    cs.GEOM_MASS = 1.0
    try:
        scene, st = cs.geometry_config("platforms", "cpu", 1, 1, torch.float32)
    finally:
        cs.GEOM_MASS = mass
    nz = cfg.near_zero(torch.float32)
    for k in range(12):
        st = stepper.step(scene, st, cs.GEOM_DT, device="cpu")
        pt = kinematics.compute(scene, st)
        _, con = nph.narrow_phase(scene, pt.pos, pt.quat, scene.contact_dist_thresh)
        act, act_lim, cnv, _ = impact._active(scene, st, pt, con, nz)
        p = impact.assemble_problem(scene, st, pt, con, act, act_lim)
        M, q, mask = impact.build_qp_lcp(scene, p, act, act_lim)
        Mm = torch.where(mask[:, :, None] & mask[:, None, :], M, 0.0)
        norm = float(Mm.abs().sum(-1).max())
        m = int(mask.sum())
        qmin = float(torch.where(mask, q, torch.inf).min()) if m else float("nan")
        print(f"step {k + 1}: t = {float(st.time[0]):.6f} s, active rows {m}, "
              f"‖M‖∞ {norm:.1f}, m·‖M‖∞·eps {m * norm * cfg.eps(torch.float32):.3e} "
              f"(NEAR_ZERO {nz:.3e}), most negative q {qmin:.3e}, "
              f"vz {np.round(st.vel[0, :, 2].numpy(), 5).tolist()}", flush=True)


def _mesh_readings(label, name, steps, band, pair, step, narrow):
    """Print one package's float32-against-float64 readings of a mesh
    configuration. `step(dtype)` advances that dtype's run and returns its
    positions (B, nb, 3); `narrow(dtype)` gives (active, point, normal) of the
    narrow phase at the float64 run's state in that dtype, as numpy."""
    f64, f32 = np.float64, np.float32
    drift, one_only, nerr = 0.0, 0, 0.0
    act = {f64: 0, f32: 0}
    dup = {f64: 0, f32: 0}
    for _ in range(steps):
        p64, p32 = step(f64), step(f32)
        drift = max(drift, float(np.abs(p64 - p32.astype(f64)).max()))
        out = {}
        for dt in (f64, f32):
            a, p, n = narrow(dt)
            act[dt] += int(a.sum())
            for bb in range(a.shape[0]):
                idx = np.flatnonzero(a[bb])
                for i, k in enumerate(idx):
                    dup[dt] += any(pair[j] == pair[k] and
                                   np.linalg.norm(p[bb, j] - p[bb, k]) < 1e-6
                                   for j in idx[:i])
            out[dt] = (a, n.astype(f64))
        (a64, n64), (a32, n32) = out[f64], out[f32]
        one_only += int((a64 != a32).sum())
        both = a64 & a32
        if both.any():
            nerr = max(nerr, float(np.abs(n64 - n32)[both].max()))
    print(f"{label} {name}: B={cs.GEOM_PARITY_BATCH} steps={steps} CPU float32 against "
          f"CPU float64: max position drift {drift:.3e} (5x: {5 * drift:.3e}); active "
          f"slots over the run float64 {act[f64]}, float32 {act[f32]}; duplicate "
          f"contacts kept float64 {dup[f64]}, float32 {dup[f32]}; slots active in one "
          f"dtype only {one_only}; largest normal difference on slots active in both "
          f"{nerr:.3e}", flush=True)


def _jitter(scene_enabled, name, B, seed):
    en = np.asarray(scene_enabled)[None, :]
    dz = np.random.default_rng(seed).uniform(0.0, cs.GEOM_LIFT, size=(B, en.shape[1])) * en
    if name == "meshstack":
        dz[:, 2] += dz[:, 1]
    return dz, cs.GEOM_DROP * en


def _jax_mesh(name, band):
    """The JAX package on the CPU, the same configuration and jitter as
    `chip_smoke.mesh_config` (its builders take either package's scene
    module), float32 scenes from `SceneBuilder(dtype=float32)`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from moby_tpu.core import scene as jsc
    from moby_tpu.geometry import narrowphase as jnph
    from moby_tpu.sim import kinematics as jkin
    from moby_tpu.sim import stepper as jstep

    B = cs.GEOM_PARITY_BATCH
    runs = {}
    for dt in (np.float64, np.float32):
        b = cs.MESH_SCENES[name](jsc)
        b.dtype = dt
        scene, st = b.compile()
        dz, dv = _jitter(scene.enabled, name, B, 1)
        st = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
        st = st.replace(pos=st.pos.at[:, :, 2].add(jnp.asarray(dz, dt)),
                        vel=st.vel.at[:, :, 2].add(-jnp.asarray(dv, dt)))
        stepf = jax.jit(jax.vmap(lambda s, scene=scene: jstep.step(scene, s, cs.GEOM_DT)))

        def narrowf(s, scene=scene):
            pt = jkin.compute(scene, s)
            return jnph.narrow_phase(scene, pt.pos, pt.quat, band)[1]

        runs[dt] = [scene, st, stepf, jax.jit(jax.vmap(narrowf))]

    def step(dt):
        runs[dt][1] = runs[dt][2](runs[dt][1])
        return np.asarray(runs[dt][1].pos)

    def narrow(dt):
        s64 = runs[np.float64][1]
        s = jax.tree_util.tree_map(
            lambda x: x.astype(dt) if jnp.issubdtype(x.dtype, jnp.floating) else x, s64)
        con = runs[dt][3](s)
        return np.asarray(con.active), np.asarray(con.point), np.asarray(con.normal)

    pair = np.asarray(runs[np.float64][0].slot_pair)
    _mesh_readings("the JAX package", name, cs.MESH_PARITY_STEPS[name], band, pair,
                   step, narrow)


def _port_mesh(name, band):
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import kinematics, stepper

    runs = {}
    for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        runs[dt] = list(cs.mesh_config(name, "cpu", cs.GEOM_PARITY_BATCH, 1, tdt)) + [tdt]

    def step(dt):
        scene, st, tdt = runs[dt]
        runs[dt][1] = stepper.step(scene, st, cs.GEOM_DT, device="cpu")
        return runs[dt][1].pos.numpy()

    def narrow(dt):
        scene, _, tdt = runs[dt]
        pt = kinematics.compute(runs[np.float64][0], runs[np.float64][1])
        _, con = nph.narrow_phase(scene, pt.pos.to(tdt), pt.quat.to(tdt), band)
        return con.active.numpy(), con.point.numpy(), con.normal.numpy()

    pair = runs[np.float64][0].host["slot_pair"]
    _mesh_readings("the port", name, cs.MESH_PARITY_STEPS[name], band, pair, step, narrow)


def mesh():
    from moby_tpu_torch import config as cfg

    band = 4.0 * cfg.near_zero(torch.float32)
    for name in cs.MESH_SCENES:
        _jax_mesh(name, band)
        _port_mesh(name, band)


def meshlcp():
    from moby_tpu_torch.sim import stepper
    from moby_tpu_torch.solvers import hopper_lcp, lcp

    torch.set_num_threads(4)
    accel = lcp._solve_accel
    origin = {lcp._solve_lcp_plain: "qp", lcp._solve_fast_lemke_plain: "stabilization"}
    counts = {}

    def counting(M, q, mask, z0, skip, plain_fallback):
        skip = lcp._no_skip(skip, q)
        Mp, qp, tol, _, ok_bp, _ = lcp._bpp_prepass(M, q, mask, z0, skip)
        work = mask.any(dim=-1) & ~skip
        rest = mask & ~(skip | ok_bp)[:, None]
        z_pl, done = hopper_lcp.ppm_lcp_plain(
            M, q, rest, z0=None if z0 is None else torch.where(rest, z0, 0.0))
        done = done & rest.any(dim=-1)
        ok_pl = done & lcp._verify(Mp, qp, z_pl, rest, tol)
        c = counts.setdefault(origin[plain_fallback], [0] * 5)
        for i, v in enumerate((work, ok_bp & work, done, done & ~ok_pl,
                               work & ~ok_bp & ~ok_pl)):
            c[i] += int(v.sum())
        return accel(M, q, mask, z0, skip, plain_fallback)

    lcp._solve_accel = counting
    try:
        for name in cs.MESH_SCENES:
            scene, st = cs.mesh_config(name, "cpu", 32, 0, torch.float32)
            secs = []
            for _ in range(2):
                t0 = time.time()
                st = stepper.step(scene, st, cs.GEOM_DT, device="cpu", cascade="accel")
                secs.append(round(time.time() - t0, 1))
            print(f"{name}: B=32 steps=2 CPU float32, the card's cascade; by LCP "
                  "[with work, BPP verified, ppm_lcp_plain done of the rest, done but "
                  f"failing complementarity, left to the plain cascade]: {counts}; "
                  f"seconds a step {secs}", flush=True)
            counts.clear()
    finally:
        lcp._solve_accel = accel


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"drift": drift, "freeze": freeze, "mesh": mesh, "meshlcp": meshlcp}[sys.argv[1] if len(sys.argv) > 1 else "drift"]()
