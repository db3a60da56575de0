#!/usr/bin/env python3
"""Float32 readings of the port's geometry configurations, on the CPU (no
card needed): what `chip_smoke.py`'s geometryparity limits and the float32
notes in ROADMAP.md rest on.

    python scripts/geometry_float32.py drift    # ~1 min
    python scripts/geometry_float32.py freeze   # ~1 min

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
"""

import os
import sys

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


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"drift": drift, "freeze": freeze}[sys.argv[1] if len(sys.argv) > 1 else "drift"]()
