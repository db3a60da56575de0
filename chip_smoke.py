#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`moby_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU (sm_90a):

    python3 chip_smoke.py

It needs no network and no JAX. Phases, each of which fails the run:

1. device  — a CUDA device is present; prints its name and power limit.
2. build   — compiles `moby_tpu_torch/csrc/ppm_lcp.cu` and `bpp_lcp.cu` with
             nvcc (both at once), loads them, and prints the registers,
             static shared memory and spills of every kernel instantiation
             (group path at G = 8, 16, 32 and block path, float and double);
             then `native/hull.cpp` (the convex hull scene compilation uses)
             with g++.
3. kernels — `hopper_lcp.ppm_lcp` against `ppm_lcp_plain` and
             `hopper_lcp.bpp_lcp` against `bpp_lcp_plain` on the card, float32
             and float64, at the contact step's shapes (n=66 and n=6, B=512)
             and, for `bpp_lcp`, at the contact-MPC's (the ball-push impact
             LCP, B=1536): monotone and KKT-shaped problems, cold and warm,
             partial masks, an all-false mask, q>0, a singular problem; for
             `bpp_lcp` also a case whose block stage runs out so that the PPM
             stage finishes, and a NaN-poisoned one. On the stack's own KKT
             problems, whose z is not unique, the contact impulses and the
             contact-space velocity change they cause are compared instead.
             Then both kernels at every group width and its edges and on
             the block path (n = 1, 6, 8, 13, 16, 17, 32, 33, 66 and 160 in
             float32, 96 in float64), B=128: groups of one warp that finish
             after 0, 1 and many iterations, partial masks and warm starts,
             NaN in q, NaN in M with and without a check tolerance,
             `max_bpp`=1, a singular problem (the tableau's fallback) and
             chains longer than its refresh interval.
4. step    — the full-width contact step: the 3-sphere friction+restitution
             stack (mu=0.5, eps=0.3, nk=16, so the impact LCP has n=66),
             float32, B=512 scenarios with per-scenario height jitter, 50
             steps of dt=1e-3 through `stepper.step`. The kernels' launch
             counts are set to 0 just before and read just after.
             Two more steps under torch.profiler then give the device's
             busy share of a step and the launches a step, by kernel name.
5. parity  — the same scene at B=4 for 50 steps: card float32 against the
             port on the CPU in float64.
6. mpc     — the full-width contact-MPC solve: `contact_mpc.solve_batch` on
             the ball-push task, B=1536 scenarios with per-scenario x jitter,
             H=50, dt=0.02, 2 iLQR iterations, float32, record/replay and warm
             start on, through the kernel route (every block-pivoting stage
             of the LCP cascade is one `bpp_lcp` launch). Launch counts are
             set to 0 just before and read just after. A second, untimed
             solve records what the cascade handed the kernel and where the
             problems left it; a short profiled solve gives the device's busy
             share and the launches per solve.
7. mpcparity — the same task at B=8: card float32 through the kernel route
             against the port on the CPU in float64 through the batched
             route.
8. block   — block-push MPC (`examples/block_push_mpc.py`: a 0.2 m cube on a
             plane, mu=0.3, nk=4, so the QP-KKT LCP has n=64 and reaches
             `bpp_lcp`'s block path), float32: (a) `contact_mpc.solve` at the
             example's own settings (one scenario, H=30, dt=0.02, 12
             iterations, target (0.6, 0.3)); (b) `solve_batch` at B=1024 with
             x and y jitter in [-0.05, 0.05) m from `--seed`, H=30, 1
             iteration (BLOCK_ITERS), in six modes: rr (the default), rr with
             the hoisted linearization, rr with forward-mode linearization
             (the block linearizer, and through the whole step), both, and
             rr with the bfloat16 Riccati form. For each: solves/s (the
             launches and idle share of rr's and rr_fwd's, BLOCK_PROFILED),
             peak device memory, the hoist's chunk count, and
             `bpp_lcp`'s launches (counts set to 0 just before, read just
             after) and calls with work. With the kernels phase, `bpp_lcp`
             is then held against `bpp_lcp_plain` on the recorded n=64 LCPs
             (by the QP's primal velocity change H·x; z on M + 0.05·I) and
             timed on them.
9. blockparity — (a)'s card solve against the port's CPU float64 solve of
             the same state (cost within 0.005 of the initial cost, final xy
             within 3 cm); every mode of (b): no NaN cost, no member above
             its start, median |c - c_rr| / c0 within 1e-3 (hoisted and
             forward modes) or 5e-3 (bf16), c0 the zero-control cost.
10. artmpc — the articulated MPC step: the double pendulum of
             `examples/double_pendulum.py` with its first joint limited at
             0.5 rad, B=256 scenarios past the stop and moving into it:
             `dstep`, its `_jacobians` and the block linearizer `f_jac`,
             card float32 against CPU float64.
11. art     — the articulated path at full width: the repo's
             `scenes/fixed-articulated-table.xml` (a floating table of five
             boxes on a plane, mu = inf: the no-slip model) loaded by
             `io.mobyxml.load` on the card, float32, B=512 scenarios with
             the spin ω_z drawn by numpy from `--seed` in [0.9, 1.1] rad/s,
             2 warm-up steps then 15 of dt=1e-3 through `stepper.step`. Its
             no-slip and stabilization LCPs (n = 40) reach `ppm_lcp`'s block
             path. The counts are set to 0 just before and read just after;
             it prints scenario-steps/s, the device's busy share and launches
             a step, `ppm_lcp`'s launches and non-empty masks, where the
             problems left `_solve_accel`, and the peak device memory. With
             the kernels phase, `ppm_lcp` is then held against
             `ppm_lcp_plain` on the problems this run recorded, float32 and
             float64.
12. artparity — card float32 against the port on the CPU in float64: the
             table at B=4 over 50 steps (max |q_art| drift at 0.05 s below
             5e-3), and the limited pendulum of the repo's articulated tests
             (stop at 0.5 rad) from q=1 over 400 steps (min q above
             0.5 - 1e-3, max |q| drift below 2e-2).
13. models  — the other contact models at full width, float32, B=512,
             dt=1e-3, through `stepper.step`: the stack with the true
             friction cone (nk=0 on its three contact pairs, whose islands
             go to the NQP; its other pairs keep nk=4), the mixed
             islands (the stack with nk=4, a no-slip sphere and a true-cone
             sphere: three impact models in one step), the compliant stack
             (penalty contact, kp=5000, kv=100, stabilization off) and a
             chain of six spheres joined by point constraints to each other
             and to a disabled anchor, lying 1 mm into the plane (bilateral
             rows and contact in one impact problem). For each: scenario-steps/s, the device's busy
             share and launches a step, `ppm_lcp`'s launches (counts set to
             0 just before, read just after) and calls with work, and the
             launches of one NQP solve. With the kernels phase, `ppm_lcp` is
             then held against `ppm_lcp_plain` on the LCPs these runs
             recorded (the NQP's kappa pre-solves, the QP islands, the
             no-slip MLCPs, stabilization).
14. modelsparity — card float32 against the port on the CPU in float64,
             B=4, 8-25 steps (MODELS_PARITY_STEPS), for those four
             configurations and a gear-coupled double pendulum and a
             planar-jointed box built in code: the
             largest position drift within MODELS_DRIFT_LIMIT, the bilateral
             violation |C| on the card below 1e-3; then a compliant ball
             settles within 10% of its spring compression mg/kp.
15. regress — the port's regress CLI (`moby_tpu_torch.cli.regress`) on
             `scenes/sitting-box.xml` and `scenes/fixed-articulated-table.xml`,
             100 steps of dt=1e-3 (the table 15), on the card and with
             `--cpu`; the two dumps compared by the port's `compare` within
             5e-3.
16. geometry — curved solids on a plane and convex polyhedra at full width,
             float32, B=512, dt=1e-3, each body lifted by [0, 0.2) mm from
             `--seed` and dropped at 0.4 m/s, 8 steps through
             `stepper.step`, each body 1 t: "curved", a cylinder
             (r=0.5, h=1) on its side spinning about its axis, a cone
             (r=0.6, h=1.2) base down and a torus (R=1, r=0.25) flat on one
             plane (narrow-phase kinds 4, 10, 5); "octastack", two
             octahedra stacked face down on the plane (kinds 3 and 9); and
             "platforms", an octahedron tip down on a BOX platform and a
             polyhedral cube on a polyhedral slab (kind 9). Kind 9 is GJK
             with the exact MTV over the hull directions. (One impact LCP
             covers a scene: the three kind-9 pairs in one scene would make
             it n >= 192, past what `ppm_lcp` takes in float32.) For
             each: scenario-steps/s, the device's busy share and launches
             a step, the launches of one `narrow_phase` call, `ppm_lcp`'s
             launches (counts set to 0 just before, read just after) and
             calls with work. With the kernels phase, `ppm_lcp` is then held
             against `ppm_lcp_plain` on the LCPs these runs recorded (the
             QP's by its velocity change H·x, as block-push's: the coplanar
             contacts make the multiplier rows of M·z not unique).
17. geometryparity — the three configurations at B=4 over 12-20 steps, card
             float32 against the port on the CPU in float64 (the largest
             position drift within GEOM_DRIFT_LIMIT, five times the CPU
             float32 reading); the cylinder's axis stays above r - 1e-3 and
             the octahedron rests on the platform within 1e-3 of 0.65 m in
             CPU float64 (within 1e-3 + 2·NEAR_ZERO on the card: float32
             stabilization parks a resting body that high); then
             the regress CLI on a scene of <Cylinder>, <Cone>, <Torus> and a
             <Polyhedron> OBJ written to a temporary directory, 200 steps on
             the card and with `--cpu`, within 5e-3 by `compare`.
18. trimesh — triangle meshes at full width, float32, B=512, dt=1e-3,
             every body 1 t, lifted by [0, 0.2) mm from `--seed` and dropped at
             0.4 m/s, 8 steps through `stepper.step` (MESH_STEPS), in four
             scenes:
             "meshes", the non-convex L-prism on the plane (kind 3) and a
             sphere in the V-notch channel (kind 11, two faces at once);
             "meshplatforms", a mesh cube on a BOX platform (kind 12);
             "meshslabs", a mesh cube on a POLYHEDRON slab (kind 13 through its
             hull triangles) and the 320-face icosphere on an extruded mesh
             slab (kind 13 through the face-tiled closest-face loop); "bigmesh",
             the 1,280-face icosphere on the plane (kind 3: 642 vertices capped
             at 16 slots by the contact-slot top-k, on tied depths). (One
             impact LCP covers a scene: the platform's and the slabs' pairs,
             or the two icospheres, in one scene would make n = 192, past
             `ppm_lcp`'s float32 gate.) The fifth scene, "meshstack", two
             mesh cubes stacked on the plane (kinds 3 and 13), runs in
             trimeshparity only: its float32 impact and stabilization LCPs
             are singular, batched BPP and `ppm_lcp` verify few of them, and
             the plain cascade that takes the rest makes a B=512 step last
             19-165 s on the card (MESH_TIMED). For each: scenario-steps/s, the
             device's busy share and launches a step, the launches and device
             time of one `narrow_phase` call, `ppm_lcp`'s launches (counts set
             to 0 just before, read just after) and calls with work, and the
             peak device memory. With the kernels phase, `ppm_lcp` is then held
             against `ppm_lcp_plain` on the LCPs these runs recorded (the QP's
             by H·x) and on those the stack's trimeshparity run recorded, each
             LCP origin's calls merged into one batch; on the stack's, a
             problem may end done and fail complementarity where the plain
             version's does too (`both_versions`, verify="as_plain").
19. trimeshparity — the five scenes at B=4 over 2-20 steps (the stack 2:
             ~30 s a step on the card), card float32
             against the port on the CPU in float64: no NaN, the largest
             position drift within MESH_DRIFT_LIMIT (five times the CPU float32
             reading of `scripts/geometry_float32.py mesh`), no plane pair with
             more active slots than VSLOT_CAP; the stack's card run records
             what it hands `ppm_lcp` for the kernels phase; then the regress
             CLI on a scene of <TriangleMesh> (two OBJs) and
             <TriangleMeshInline> written to a temporary directory, 200 steps
             on the card and with `--cpu`, within 5e-3 by `compare`.

Then each kernel is timed on the inputs the main paths really gave it,
beside its plain version, its bound and its launch floor (the same call with
an all-false mask); `bpp_lcp` also beside the batched
`lcp_bpp` + `_verify` pair it stands for, on the MPC's inputs and on the
step's recorded stage-1 problems. Output: a `{"kernels": [...]}` JSON line,
the card's name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device the script exits with a non-zero code and no result.
`--phases kernels`, `--phases mpc`, `--phases block,blockparity,artmpc`,
`--phases art`, `--phases models,modelsparity,regress`,
`--phases geometry,geometryparity` or `--phases trimesh,trimeshparity` are
the short runs (no result line).
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("device", "build", "kernels", "step", "parity", "mpc", "mpcparity",
          "block", "blockparity", "artmpc", "art", "artparity", "models",
          "modelsparity", "regress", "geometry", "geometryparity", "trimesh",
          "trimeshparity")
BATCH = 512          # scenarios of the full-width step
MPC_BATCH = 1536     # scenarios of the full-width contact-MPC solve
MPC_HORIZON = 50     # steps of dt = MPC_DT in the MPC's horizon
MPC_DT = 0.02
# iLQR iterations of one solve (4 until the mesh phases took a run on a
# slower host past the script's 1,200 s: PERF.md §6)
MPC_ITERS = 2
MPC_PARITY_BATCH = 8
STAGE1_KEEP = 16     # of the step's stage-1 problems kept for the timing
# final mean cost, card float32 (kernel route) against CPU float64 (batched
# route): iLQR is a local method and float32 rounding can move a member to
# another line-search step; the means agree far inside this
MPC_PARITY_RTOL = 0.05
STEPS = 50           # steps of the full-width run
PARITY_STEPS = 50    # steps of the float32-card against float64-CPU run (200 before the mesh phases)
TABLE_XML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes",
                         "fixed-articulated-table.xml")
ART_BATCH = 512      # scenarios of the full-width articulated run
# 15 timed steps, not 50: the new phases took the script past 8 minutes,
# and the mesh phases past 1,200 s on a slower host (a table step is about
# 0.6-0.95 s on the host at B=512; PERF.md §5)
ART_STEPS = 15
ART_WARMUP = 2
ART_DT = 1e-3        # the JAX package's on-device smoke step (tpu_smoke.py:146)
ART_PARITY_BATCH = 4
# 50 and 400 steps, not 200 and 800: with the block-push phases a full run
# on a slower host came to about 1,010 s of the 1,200 allowed (PERF.md §6),
# and with the mesh phases one went past it (the table takes ~0.4 s a step
# on the card at B=4)
ART_PARITY_STEPS = 50
ART_DRIFT_LIMIT = 5e-3      # max |q_art| drift at the end (tpu_smoke.py:154: at 0.2 s)
PEND_STEPS = 400
PEND_MIN_Q = 0.5 - 1e-3     # the JAX test's own bound (test_joint_limit_stops)
PEND_DRIFT_LIMIT = 2e-2     # max |q| drift over the 800 steps
# block-push (`examples/block_push_mpc.py`): the example's own settings for
# the single solve, then BLOCK_BATCH scenarios in every mode
BLOCK_HORIZON = 30
BLOCK_DT = 0.02
BLOCK_TARGET = (0.6, 0.3)
BLOCK_SINGLE_ITERS = 12
BLOCK_BATCH = 1024
# each batch solve runs one iteration (four, then two, before the mesh
# phases), the one blockparity holds against rr, and the device is profiled
# for rr and rr_fwd only (reverse against forward mode, PERF.md §7): a run
# on a slower host went past the script's 1,200 s (PERF.md §6)
BLOCK_ITERS = 1
BLOCK_PROFILED = ("rr", "rr_fwd")
BLOCK_JITTER = 0.05         # x and y jitter of the batch's blocks, metres
BLOCK_MODES = (
    ("rr", {}),
    ("rr_hoist", {"hoist_linearization": True}),
    ("rr_fwd", {"linearize_fwd": True}),
    ("rr_fwd_full", {"linearize_fwd": True, "block_jac": False}),
    ("rr_fwd_hoist", {"linearize_fwd": True, "hoist_linearization": True}),
    ("rr_bf16", {"bf16": True}),
)
# blockparity's limits (PERF.md §2). Block-push's solves are decided by
# rounding: its four coplanar contacts make the LCP's active block singular,
# so the IFT derivative follows the dtype's Tikhonov shift and the rounding
# of the regularized inverse, and the cascade's regularized stages give the
# two dtypes different contact dynamics. The JAX package shows the same
# (scripts/block_push_dtype_gap.py, PERF.md §6): its float32 solve and the
# port's end at other costs than float64, and the port's float32 single
# solve on the CPU moves with the thread count. So the single solve's costs
# against the CPU are readings, and what is held is
# (a) the example's purpose: the single solve leaves the block within
# BLOCK_TARGET_DIST of the target (the CPU float64 solve: 0.9 mm);
# (b) each mode against rr where they must agree, one iteration from the
# shared start (the same linearization point): the median over members of
# |c_mode - c_rr| / |c_rr| within BLOCK_MODE_RTOL; bf16 changes the gains by
# its rounding there, so its Riccati step is held instead, card float32
# against CPU float64 of the same rounding, within BLOCK_RICCATI_RTOL: set
# from the card's reading (2.1e-7) to stay ten times below what the
# bfloat16 rounding does to the gains (9.9e-4 of their scale), so that the
# check tells the two steps apart.
BLOCK_TARGET_DIST = 0.01        # metres, of a 0.67 m push
BLOCK_MODE_RTOL = 1e-2
BLOCK_RICCATI_RTOL = 1e-5
BLOCK_RICCATI_BATCH = 64
ART_MPC_BATCH = 256
ART_MPC_DT = 0.01
# card float32 against CPU float64 on the limited double pendulum: the
# step's state (absolute, entries of order 1) and its Jacobians (relative to
# their largest entry: the IFT inverse's Tikhonov shift is sqrt(eps)·‖M‖∞,
# 3.4e-4·‖M‖∞ in float32, which moves these Jacobians by 7e-4 of their scale
# in a float32 run on the CPU)
ART_MPC_TOL = {"dstep": 1e-4, "jacobian": 5e-3}
MODELS_BATCH = 512          # scenarios of each full-width run of the other models
MODELS_DT = 1e-3
# timed steps of each configuration at MODELS_BATCH, from the jittered
# initial state (a warm-up step from the same state is not counted). In
# float32 (NEAR_ZERO = 3.45e-4) stabilization parks a body 2·NEAR_ZERO above
# its support, velocity untouched, so a resting float32 stack's impacts come
# in bursts about 35 steps apart; the first step resolves the jitter's
# initial overlaps
MODELS_STEPS = {"truecone": 8, "mixed": 8, "compliant": 40, "chain": 20}
MODELS_PARITY_BATCH = 4
# steps of each parity run: at B=4 the card is launch-bound, 0.75 s a step
# for the NQP configurations and 0.2 s for the chain, and the CPU float64
# reference of the NQP ones takes 0.5 s a step (the mixed scene's true-cone
# sphere takes ~23 mini-steps a step there from step 55 on)
# (halved for compliant, chain, gear and planar with REGRESS_STEPS)
MODELS_PARITY_STEPS = {"truecone": 8, "mixed": 8, "compliant": 25,
                       "chain": 15, "gear": 25, "planar": 15}
# largest position/joint drift, card float32 against CPU float64: five
# times what the same code gave in float32 against float64 on the CPU
# (B=4, seed 1) over 30 steps (truecone, mixed) or 100 (the rest): 1.79e-3,
# 2.63e-3, 1.39e-6, 1.11e-3, 3.84e-7, 3.01e-4
MODELS_DRIFT_LIMIT = {"truecone": 9e-3, "mixed": 1.4e-2, "compliant": 7e-6,
                      "chain": 5.6e-3, "gear": 2e-6, "planar": 1.6e-3}
BILATERAL_VIO_LIMIT = 1e-3  # max |C| of the bilateral constraints on the card
COMPLIANT_KP = 5000.0
COMPLIANT_SETTLE_STEPS = 200
COMPLIANT_SETTLE_RTOL = 0.1  # of the spring compression mg/kp
# steps of each regress dump: the table takes 0.35-0.45 s a step on the
# card at B=1 (its CPU float64 run 0.05 s), so it runs 30
GEOM_BATCH = 512           # scenarios of each full-width geometry run
GEOM_DT = 1e-3
GEOM_LIFT = 2e-4           # each body starts up to this far above its rest (--seed)
# every body is dropped at this speed onto its support: float32
# stabilization holds a resting body 2·NEAR_ZERO up until it falls faster
# than NEAR_ZERO a step (ROADMAP §3), which would put the first impacts some
# 37 steps in
GEOM_DROP = 0.4            # m/s
GEOM_STEPS = {"curved": 8, "octastack": 8, "platforms": 8}
GEOM_PARITY_BATCH = 4
# short runs keep both geometry phases near 150 s: kind 9's GJK costs ~0.5 s
# a step at B=4 in launches (NVIDIA H100 80GB HBM3, 700 W), and once the
# spinning cylinder rests on its side the CPU float64 reference can run the
# CA loop its 1,024 iterations a step (~1.4 s a step on that machine's
# host; the JAX package does the same)
GEOM_PARITY_STEPS = {"curved": 12, "octastack": 20, "platforms": 20}
# 5x the largest position drift of the port's CPU float32 run against its
# CPU float64 run of the same configuration, B=4, seed 1, GEOM_PARITY_STEPS
# (`scripts/geometry_float32.py drift`): 1.381e-3, 2.454e-3, 1.366e-3
GEOM_DRIFT_LIMIT = {"curved": 6.9e-3, "octastack": 1.23e-2, "platforms": 6.83e-3}
CYL_MIN_Z = 0.5 - 1e-3     # the cylinder's axis above the plane: r - 1e-3
NEAR_ZERO_F32 = float(np.sqrt(np.finfo(np.float32).eps))
OCTA_REST_Z = 0.65         # tests/test_gjk.py::test_octahedron_rests_on_box
OCTA_REST_TOL = 1e-3
GEOM_REGRESS_STEPS = 200
# every body of the geometry configurations weighs 1 t (inertia to match):
# rigid motion does not depend on mass, but the LCP's float32 tolerance
# m·‖M‖∞·eps does, and with the tests' 1 kg bodies a resting convex
# manifold's far corner contacts raise it past NEAR_ZERO, so that an
# approach slower than it is never solved and the mini-step loop stops
# (ROADMAP §3)
GEOM_MASS = 1000.0
# 100 and 15 steps (200 and 30 before the mesh phases): a whole run on a
# slower host took 1,221.8 s of the 1,200 allowed (PERF.md §6)
REGRESS_STEPS = {"sitting-box.xml": 100, "fixed-articulated-table.xml": 15}
REGRESS_DT = 1e-3
REGRESS_TOL = 5e-3          # scripts/tpu_smoke.py's table drift at 0.2 s
SOURCE = "moby_tpu_torch/csrc/ppm_lcp.cu"
REPLACES = "moby_tpu/solvers/pallas_lcp.py:226"   # ppm_lcp_one's pl.pallas_call
BPP_SOURCE = "moby_tpu_torch/csrc/bpp_lcp.cu"
BPP_REPLACES = "moby_tpu/solvers/pallas_lcp.py:591"   # bpp_lcp_batched's (and :546, bpp_lcp_one's)
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


def plane_quat():
    from moby_tpu_torch.math import quaternion as quat

    return quat.from_rpy(
        torch.tensor([1.5707963267949, 0, 0], dtype=torch.float64)).numpy()


def make_stack(nk=16, compliant=False):
    """The 3-sphere friction+restitution stack of the repo's benchmark
    (mu=0.5, eps=0.3); nk=0 asks for the true friction cone (the NQP);
    `compliant` makes every sphere a penalty body (kp=5000, kv=100, with
    stabilization off, as tests/test_compliant.py sets them)."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    inertia = sc.sphere_inertia(1.0, 1.0)
    for i, n in enumerate(("sph1", "sph2", "sph3")):
        b.add_body(n, mass=1.0, inertia=inertia, pos=np.array([0, 0, 1.0 + 2 * i]),
                   compliant=compliant)
    b.add_body("ground", enabled=False)
    for n in ("sph1", "sph2", "sph3"):
        b.add_geom(n, sc.SPHERE, [1.0])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    cp = sc.ContactParams(epsilon=0.3, mu_coulomb=0.5, nk=nk,
                          penalty_kp=5000.0 if compliant else 0.0,
                          penalty_kv=100.0 if compliant else 0.0)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    if compliant:
        b.stab_max_iters = 0
    return b


def build_stack(device, dtype=None):
    return make_stack().compile(device=device, dtype=dtype)


def build_ballpush(device, dtype=None):
    """The ball-push scene of the repo's contact-MPC benchmark: a ball of
    radius 0.5 on a plane, mu=0.5, no restitution, nk=4."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4))
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
    from moby_tpu_torch.geometry import hull
    from moby_tpu_torch.solvers import hopper_lcp

    t0 = time.time()
    paths = hopper_lcp.build(force=True)
    hopper_lcp._load()
    log(f"[build] nvcc -> {sorted(paths.values())} in {time.time() - t0:.1f} s")
    t0 = time.time()
    log(f"[build] g++ -> {hull.build(force=True)} (the convex hull of BOX and "
        f"POLYHEDRON geometry at compile) in {time.time() - t0:.1f} s")
    for line in hopper_lcp.build_log.splitlines():
        if "error" in line.lower():
            log(f"[build] {line.strip()}")
    for name, regs, smem, spills in ptxas_report(hopper_lcp.build_log):
        log(f"[build] {name}: {regs} registers, {smem} bytes static shared memory, "
            f"spill stores/loads {spills}")


def ptxas_report(text):
    """[(kernel, registers, static shared bytes, "stores/loads" spill bytes)]
    for each kernel instantiation in `nvcc -Xptxas -v` output, with the names
    demangled by c++filt where there is one."""
    import re
    import shutil

    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = [m.group(1), None, None, None]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur[3] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur[2] = int(sm.group(1)) if sm else 0
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, d in zip(rows, out):
            r[0] = d.replace("(anonymous namespace)::", "").split("(")[0] or r[0]
    assert rows, "build: nvcc printed no kernel properties (-Xptxas -v)"
    return [tuple(r) for r in rows]


def verified(M, q, mask, z):
    """(B,) bool: z satisfies complementarity at the cascade's `_check_tol`
    (`lcp._verify`, what `_solve_accel` asks of a problem `ppm_lcp` calls
    done before it takes its z)."""
    from moby_tpu_torch.solvers import lcp

    Mp, qp = lcp.pad_lcp(M, q, mask)
    return lcp._verify(Mp, qp, z, mask, lcp._check_tol(Mp, mask))


def both_versions(name, M, q, mask, z0, verify=True, solver="ppm", **kw):
    """Kernel and plain version on one batch: (zk, dk, zp, dp, pivots), after
    checking that the kernel's z is finite and (with `verify`) that every
    problem either version calls done satisfies complementarity. With
    `verify="as_plain"` a problem may be done and fail complementarity where
    the plain version's is as well: PPM's `done` reads its pivot rule's own
    tolerance on z solved from the nonbasic system, which on a singular
    float32 LCP (the mesh stack's) is not the residual `_verify` reads, so
    the pivoting itself ends done there, and the cascade re-verifies. The
    kernel must then call done no problem the plain version solves (done and
    complementary) and leave complementarity. `done` itself is read, not
    held: on these singular LCPs PPM's first-minimum rule meets ties that
    rounding decides, so a chain that ends done in one version can run into
    the pivot cap in the other (`check_velocity_case`; 6 of the stack's 22
    stabilization problems on the card). `solver` is "ppm" or "bpp";
    `kw` goes to both versions (max_bpp, max_piv, check_tol). For "bpp"
    `pivots` counts block iterations and PPM pivots together."""
    from moby_tpu_torch.solvers import hopper_lcp

    if solver == "ppm":
        zk, dk = hopper_lcp.ppm_lcp(M, q, mask, z0=z0, **kw)
        torch.cuda.synchronize()
        zp, dp, piv, _ = hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0,
                                                  with_pivots=True, **kw)
    else:
        zk, dk = hopper_lcp.bpp_lcp(M, q, mask, z0=z0, **kw)
        torch.cuda.synchronize()
        zp, dp, its, piv, _ = hopper_lcp.bpp_lcp_plain(M, q, mask, z0=z0,
                                                       with_pivots=True, **kw)
        piv = piv + its
    torch.cuda.synchronize()
    assert torch.isfinite(zk).all(), f"{name}: kernel returned non-finite z"
    if verify == "as_plain":
        work = mask.any(dim=1)
        ok_k, ok_p = verified(M, q, mask, zk), verified(M, q, mask, zp)
        worse = int((dk & ~ok_k & dp & ok_p).sum())
        n_diff = int(((dk != dp) & work).sum())
        log(f"[kernels] {name:44s} {str(M.dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
            f"with work={int(work.sum())}: done and failing complementarity "
            f"kernel={int((dk & ~ok_k).sum())} plain={int((dp & ~ok_p).sum())}, of "
            f"those the kernel's where the plain version solves it={worse}; done "
            f"differs on {n_diff}")
        assert worse == 0, (
            f"{name}: {worse} problems the plain version solves the kernel calls "
            f"done and fails complementarity")
    elif verify:
        for who, z, d in (("kernel", zk, dk), ("plain", zp, dp)):
            bad = int((d & ~verified(M, q, mask, z)).sum())
            assert bad == 0, f"{name}: {bad} problems {who} calls done fail complementarity"
    return zk, dk, zp, dp, piv


def check_kkt_case(name, scene, A, M, q, mask, z0, solver="ppm",
                   min_both=0.3, min_well=0.1, well_tol=TOL, **kw):
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
    zk, dk, zp, dp, _ = both_versions(name, M, q, mask, z0, solver=solver, **kw)
    n_diff = int((dk != dp).sum())
    assert n_diff <= 0.15 * len(dk), (
        f"{name}: done differs on {n_diff} of {len(dk)} problems")
    both = dk & dp
    assert int(both.sum()) >= min_both * len(dk), f"{name}: too few problems done in both"
    if not bool(both.any()):
        log(f"[kernels] {name:34s} {str(dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
            f"done kernel={int(dk.sum())} plain={int(dp.sum())} differ={n_diff}: "
            f"none done in both, nothing to compare")
        return 0.0, 0.0
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
    assert int(well.sum()) >= min_well * len(dk), f"{name}: too few well-conditioned problems"
    i_diff = (ik - ip).abs().amax(dim=1)
    if not bool(well.any()):
        well = cond <= cond.min()      # compare the best-conditioned one
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
    assert float(v_diff[well].max()) <= well_tol[dtype] * v_scale, (
        f"{name}: contact-space velocity change differs by "
        f"{float(v_diff[well].max()):.3e} where A is well conditioned")
    assert i_err <= well_tol[dtype] * i_scale, (
        f"{name}: impulses differ by {i_err:.3e} where A is well conditioned")
    return v_err, i_err


def check_case(name, M, q, mask, z0, verify=True, solver="ppm", **kw):
    """Kernel against plain version on one batch: equal `done`, z within TOL,
    complementarity of what is done. Returns (max_abs_err, n_done, pivots)."""
    dtype = M.dtype
    zk, dk, zp, dp, piv = both_versions(name, M, q, mask, z0, verify,
                                        solver=solver, **kw)
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


def phase_kernels_bpp():
    """`hopper_lcp.bpp_lcp` against `bpp_lcp_plain` on the card, float32 and
    float64: at the contact-MPC's shape (the ball-push impact LCP, B=MPC_BATCH)
    and at the contact step's (n=66 and n=6, B=BATCH). Returns the largest
    |z_kernel - z_plain| over the cases where z is unique."""
    from moby_tpu_torch.solvers.hopper_lcp import bpp_lcp_plain

    n_mpc = build_ballpush("cpu")[0].n_lcp
    log(f"[kernels] bpp_lcp: the ball-push impact LCP has n={n_mpc}")
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for n, B in ((n_mpc, MPC_BATCH), (66, BATCH), (6, BATCH)):
            def case(name, *a, **kw):
                return check_case(f"bpp {name} n={n}", *a, solver="bpp", **kw)

            M, q = monotone(B, n, 1, dtype)
            full = torch.ones(B, n, dtype=torch.bool, device=DEVICE)
            e, nd, _ = case("monotone cold", M, q, full, None, max_bpp=12)
            assert nd == B
            worst = max(worst, e)
            zc, okc = bpp_lcp_plain(M, q, full, max_bpp=12)
            assert bool(okc.all())
            # warm from the cold solution: the same z, in one iteration (a
            # few more where a component of z lies below ztol and so is not
            # in the warm start's support)
            e, nd, piv = case("monotone warm from solution", M, q, full,
                              zc.contiguous(), max_bpp=12)
            assert nd == B and float(piv.double().mean()) < 3.0
            worst = max(worst, e)
            rng = np.random.default_rng(2)
            part = torch.tensor(rng.uniform(size=(B, n)) < 0.7, device=DEVICE)
            part[0] = False
            z0 = torch.tensor(np.abs(rng.normal(size=(B, n))), dtype=dtype,
                              device=DEVICE)
            z0[:, ::2] = 0.0
            e, nd, _ = case("monotone warm garbage, partial mask", M, q, part,
                            z0, max_bpp=12)
            assert nd == B
            worst = max(worst, e)
            none = torch.zeros_like(full)
            e, nd, piv = case("all-false mask", M, q, none, z0)
            assert nd == B and e == 0.0 and int(piv.sum()) == 0
            e, nd, piv = case("q>0", M, q.abs() + 0.1, full, None)
            assert nd == B and e == 0.0 and int(piv.sum()) == 0
            # the block stage runs out after one iteration and the PPM stage
            # finishes from its basis
            e, nd, piv = case("monotone max_bpp=1 (PPM stage finishes)", M, q,
                              full, None, max_bpp=1)
            assert nd == B and int(piv.max()) > 1
            worst = max(worst, e)
            if n > 2:
                # singular: a zero row/column whose q wants to enter, so
                # w = -1 there whatever z is. ok is verified: both say 0
                # (where 1 > tol = m·‖M‖∞·sqrt(eps)) or both 1 (float32 at
                # n=66, where tol is about 10)
                Ms, qs = M.clone(), q.clone()
                Ms[:, 2, :] = 0.0
                Ms[:, :, 2] = 0.0
                qs[:, 2] = -1.0
                e, nd, _ = case("singular (zero row/col)", Ms, qs, full, None,
                                max_bpp=12)
                assert nd in (0, B)
                # NaN in q: no violator is ever seen, the check fails: ok=0
                qn = -q.abs()
                qn[:, 1] = float("nan")
                zk, okk, zp, okp, _ = both_versions(
                    f"bpp NaN in q n={n}", M, qn, full, None, verify=False,
                    solver="bpp", max_bpp=12)
                assert not bool(okk.any()) and not bool(okp.any()), (
                    f"bpp NaN in q n={n}: ok set on a poisoned problem")
                e = float((zk - zp).abs().max())
                assert e <= TOL[dtype] * max(1.0, float(zp.abs().max()))
                log(f"[kernels] bpp NaN in q n={n:<3d}                  "
                    f"{str(dtype)[6:]:8s} B={B} ok=0 in both, max_abs_err={e:.3e}")
        scene, Ak, Mk, qk, mk = stack_kkt(BATCH, 3, dtype)
        # `ok` is verified here, and the block stage needs the friction
        # splits' exact ties to fall well, so fewer of these made-up problems
        # end ok than end `done` in the PPM kernel: no minimum count. Where
        # rounding sends the two versions to different bases, both accepted
        # at ztol, the well-conditioned problems' impulses differ by up to
        # cond(A)·ztol (44 · 3e-4 in float32), which is KKT_VELOCITY_TOL's
        # order and not TOL's
        check_kkt_case("bpp stack KKT n=66 cold", scene, Ak, Mk, qk, mk, None,
                       solver="bpp", min_both=0.0, min_well=0.0,
                       well_tol=KKT_VELOCITY_TOL, max_bpp=12)
        Mr = (Mk + 0.05 * torch.diag_embed(mk.to(dtype))).contiguous()
        e, nd, _ = check_case("bpp stack KKT + 0.05 I n=66 cold", Mr, qk, mk,
                              None, solver="bpp", max_bpp=12)
        assert nd == BATCH
        worst = max(worst, e)
    return worst


def edge_case(kernel, name, M, q, mask, z0=None, verify=True, **kw):
    """Kernel against plain version on one batch (`both_versions`, solver
    "ppm" or "bpp"): `ok`/`done` equal and z within TOL. Returns
    (max_abs_err, ok (B,), pivots (B,))."""
    label = f"{kernel} {name}"
    zk, okk, zp, okp, piv = both_versions(label, M, q, mask, z0, verify,
                                          solver=kernel, **kw)
    n_diff = int((okk != okp).sum())
    assert n_diff == 0, f"{label}: ok differs on {n_diff} of {len(okk)} problems"
    scale = max(1.0, float(zp.abs().max()))
    err = float((zk - zp).abs().max())
    assert err <= TOL[M.dtype] * scale, (
        f"{label}: max|z_kernel - z_plain| = {err:.3e} > {TOL[M.dtype]:.0e}*{scale:.3g}")
    log(f"[kernels] {label:44s} {str(M.dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
        f"ok={int(okk.sum())}/{len(okk)} pivots={int(piv.sum())} (max {int(piv.max())}) "
        f"max_abs_err={err:.3e}")
    return err, okk, piv


def phase_kernels_edges():
    """Both kernels against their plain versions at every group width and its
    edges (n = 1, 6, 8, 13, 16, 17, 32) and on the block path (n = 33, 66,
    and 160 in float32, 96 in float64), float32 and float64: a batch in which
    the groups of one warp finish after 0 (all-false mask), 0 (q > 0), 1
    (warm from the solution) and many (cold) iterations; a partial mask with
    a warm start that is not a solution; NaN in q; NaN in M with and, for
    `bpp_lcp`, without a check tolerance; `max_bpp`=1; a singular problem,
    whose zero pivot sends the block path's pivot loop to its fresh
    Gauss–Jordan. Cold chains at n >= 66 take more than kRefresh = 16 pivots,
    so the tableau is rebuilt on its way. Returns the largest error."""
    from moby_tpu_torch.solvers import hopper_lcp, lcp

    worst = 0.0
    B = 128
    for dtype in (torch.float32, torch.float64):
        big = 160 if dtype == torch.float32 else 96
        for n in (1, 6, 8, 13, 16, 17, 32, 33, 66, big):
            M, q = monotone(B, n, 5 + n, dtype)
            full = torch.ones(B, n, dtype=torch.bool, device=DEVICE)
            zc, _ = hopper_lcp.ppm_lcp_plain(M, q, full)
            # groups of one warp leave after 0, 0, 1 and many iterations
            mixed = full.clone()
            mixed[0::4] = False
            qm = q.clone()
            qm[1::4] = q[1::4].abs() + 0.1
            z0 = torch.zeros_like(q)
            z0[2::4] = zc[2::4]
            rng = np.random.default_rng(n)
            part = torch.tensor(rng.uniform(size=(B, n)) < 0.7, device=DEVICE)
            garbage = torch.tensor(np.abs(rng.normal(size=(B, n))), dtype=dtype,
                                   device=DEVICE)
            garbage[:, ::2] = 0.0
            qn = -q.abs()
            qn[0::2, n // 2] = float("nan")
            Mn = M.clone()
            Mn[1::2, 0, n - 1] = float("nan")
            Mp, _ = lcp.pad_lcp(Mn, q, full)
            tol_n = lcp._check_tol(Mp, full).contiguous()
            for kernel, kw in (("ppm", {}), ("bpp", {"max_bpp": 12})):
                tag = f"n={n}"
                e, ok, piv = edge_case(kernel, f"mixed warp 0/0/1/many {tag}", M, qm,
                                       mixed, z0, **kw)
                assert bool(ok.all()) and int(piv[0::4].max()) == 0
                if n >= 66 and kernel == "ppm":
                    assert int(piv[3::4].max()) > 16, "no chain long enough to refresh"
                worst = max(worst, e)
                e, ok, _ = edge_case(kernel, f"partial mask, warm garbage {tag}", M, q,
                                     part, garbage, **kw)
                worst = max(worst, e)
                e, ok, _ = edge_case(kernel, f"NaN in q {tag}", M, qn, full,
                                     verify=False, **kw)
                # (n=1: the only q is NaN, the start set is empty: trivial)
                assert not bool(ok[0::2].any()) or (kernel == "bpp" and n == 1)
                e, ok, _ = edge_case(kernel, f"NaN in M {tag}", Mn, q, full,
                                     verify=False, **kw)
                assert bool(ok[1::2].all() if kernel == "bpp" else not ok[1::2].any())
                if kernel == "bpp":
                    e, ok, _ = edge_case(kernel, f"NaN in M, check_tol {tag}", Mn, q,
                                         full, verify=False, check_tol=tol_n, **kw)
                    assert not bool(ok[1::2].any()) and bool(ok[0::2].all())
                    e, ok, _ = edge_case(kernel, f"max_bpp=1 (PPM stage) {tag}", M, q,
                                         full, max_bpp=1)
                    worst = max(worst, e)
                if n > 2:
                    Ms, qs = M.clone(), q.clone()
                    Ms[:, 2, :] = 0.0
                    Ms[:, :, 2] = 0.0
                    qs[:, 2] = -1.0
                    qs[0::2, 2] = -50.0   # the cold start pivots on it first
                    e, _, _ = edge_case(kernel, f"singular (zero pivot) {tag}", Ms, qs,
                                        full, verify=False, **kw)
                    worst = max(worst, e)
    return worst


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
    from moby_tpu_torch.solvers import hopper_lcp, lcp

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

    # ... and the stage-1 problems of the cascade (what batched `lcp_bpp` is
    # given), so that `bpp_lcp` can be timed on them beside it
    stage1 = []
    batched_bpp = lcp.lcp_bpp

    def recording_bpp(M, q, mask, z0=None, skip=None, **kw):
        stage1.append((M, q, mask, z0, skip))
        return batched_bpp(M, q, mask, z0=z0, skip=skip, **kw)

    stepper.step(scene, st, 1e-3, device=DEVICE)   # warm-up step, not counted
    torch.cuda.synchronize()
    # the wrapper counts on the function that `hopper_lcp.ppm_lcp` names, so
    # the stand-in carries the count while it is in place
    hopper_lcp.ppm_lcp = recording
    lcp.lcp_bpp = recording_bpp
    recording.launches = 0
    hopper_lcp.bpp_lcp.launches = 0
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
    lcp.lcp_bpp = batched_bpp
    assert hopper_lcp.bpp_lcp.launches == 0    # the step's cascade has no bpp_lcp stage
    # keep the stage-1 problems that had something to solve
    stage1 = [r for r in stage1
              if r[4] is None or not bool(r[4].all())][:STAGE1_KEEP]

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
    return launches, recorded, B * n_steps / elapsed, stage1


def device_share(step_fn, step_seconds, n_steps=2, tag="step"):
    """Where a step's time goes: the device time of `n_steps` more steps by
    kernel name (torch.profiler), against the unprofiled step time measured
    just before. A reading, not a check: prints "not measured" if the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    # device activity only: with the host's operators recorded too, each
    # kernel's time and launch counts twice, under its operator and under
    # its own name
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step_fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages() if ev.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / n_steps / 1e6
    if busy <= 0:
        log(f"[{tag}] device time per step: not measured (profiler saw no kernel)")
        return
    n_kernels = sum(r[2] for r in rows) / n_steps
    log(f"[{tag}] device busy {busy * 1e3:.2f} ms of a {step_seconds * 1e3:.2f} ms step "
        f"(idle share {1.0 - busy / step_seconds:.3f}), {n_kernels:.0f} kernel launches a step")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[{tag}]   {us / n_steps / 1e3:8.3f} ms/step {count / n_steps:8.0f} launches/step  {key[:90]}")


# --------------------------------------------------------------------- MPC
def ballpush_task(device, B, seed, dtype=None):
    """The ball-push contact-MPC task of the repo's benchmark: push the ball
    to x=0.5 at the end of the horizon with small control effort. B scenarios
    with a numpy-made x jitter of the ball in [-0.1, 0.1)."""
    from moby_tpu_torch.mpc import contact_mpc

    scene, st = build_ballpush(device, dtype)
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=MPC_DT,
                                  horizon=MPC_HORIZON)
    dx = np.random.default_rng(seed).uniform(size=B) * 0.2 - 0.1
    states = st.expand(B)
    pos = states.pos.clone()
    pos[:, 0, 0] += torch.tensor(dx, dtype=pos.dtype, device=pos.device)
    states = states.replace(pos=pos)
    target = torch.tensor([0.5, 0.0], dtype=pos.dtype, device=pos.device)

    def cost(x, u):
        return 1e-4 * (u[:, :6] ** 2).sum(dim=1)

    def cost_final(x):
        return 50.0 * ((x[:, 0:2] - target) ** 2).sum(dim=1)

    return prob, states, cost, cost_final


def phase_mpc():
    """The second main path: MPC_BATCH ball-push solves through
    `contact_mpc.solve_batch` on the card."""
    from moby_tpu_torch.mpc import contact_mpc
    from moby_tpu_torch.solvers import difflcp, hopper_lcp, lcp

    B = MPC_BATCH
    prob, states, cost, cost_final = ballpush_task(DEVICE, B, 0)
    assert states.pos.dtype == torch.float32
    n = prob.scene.n_lcp
    assert difflcp._use_kernel(states.zlast[:, None, :].expand(B, n, n),
                               difflcp.DEFAULT_OPTIONS), "mpc: not on the kernel route"

    def solve(n_iters):
        return contact_mpc.solve_batch(prob, states, cost, cost_final,
                                       n_iters=n_iters, device=DEVICE)

    c0 = solve(0).cost            # the initial rollout's cost
    solve(1)                      # warm-up of the backward sweep, not counted
    torch.cuda.synchronize()

    # ---- the timed solve: counts to 0 just before, read just after
    hopper_lcp.bpp_lcp.launches = 0
    hopper_lcp.ppm_lcp.launches = 0
    t0 = time.time()
    res = solve(MPC_ITERS)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = hopper_lcp.bpp_lcp.launches
    assert hopper_lcp.ppm_lcp.launches == 0     # the PPM rescue is off by default

    nan = int((~torch.isfinite(res.cost)).sum())
    assert nan == 0, f"mpc: {nan} members ended with a non-finite cost"
    assert res.us.shape == (B, MPC_HORIZON, 6) and res.xs.shape == (B, MPC_HORIZON + 1, 13)
    assert torch.isfinite(res.us).all() and torch.isfinite(res.xs).all()
    worse = int((res.cost > c0).sum())
    assert worse == 0, f"mpc: {worse} members ended above their initial cost"
    fell = float((res.cost < c0).double().mean())
    assert launches > 0, "mpc: the solve never launched bpp_lcp"
    log(f"[mpc] B={B} H={MPC_HORIZON} dt={MPC_DT} iters={MPC_ITERS} float32 n_lcp={n}: "
        f"{elapsed:.2f} s, {B / elapsed:.1f} solves/s")
    log(f"[mpc] cost: initial mean {float(c0.mean()):.4f}, final mean "
        f"{float(res.cost.mean()):.4f}, worst {float(res.cost.max()):.4f}; cost fell "
        f"for {fell:.3f} of the members; NaN costs {nan}")
    # the ball was pushed toward the target, and stays on the plane
    x_end = res.xs[:, -1, 0]
    assert float((x_end - 0.5).abs().mean()) < float((res.xs[:, 0, 0] - 0.5).abs().mean())
    assert float(res.xs[:, :, 2].min()) > 0.5 - 5e-3, "mpc: the ball sank into the plane"

    # ---- the same solve again, untimed: what the cascade handed the kernel
    # and where the problems left it. With the default options a cascade is
    # four `bpp_lcp` calls (stage 1, stage 2, two ladder rungs), each handed
    # only what the stages before it left unsolved, then the regularized
    # sweep on the rest; whatever that leaves is poisoned.
    assert difflcp.DEFAULT_OPTIONS.stage2 and len(difflcp.DEFAULT_OPTIONS.ladder) == 2 \
        and not difflcp.DEFAULT_OPTIONS.ppm_rescue and difflcp.DEFAULT_OPTIONS.rescue
    position = ("stage1", "stage2", "ladder", "ladder")
    recorded = []
    counts = {"calls": 0}
    tally = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
             for k in ("empty", "stage1", "stage2", "ladder", "rescue", "poisoned")}
    handed = 0
    wrapper, sweep = hopper_lcp.bpp_lcp, lcp.lcp_fast_regularized

    def recording(M, q, mask, z0=None, max_bpp=24, max_piv=None, check_tol=None):
        nonlocal handed
        pos = counts["calls"] % 4
        counts["calls"] += 1
        handed += mask.shape[0]
        # whole cascades, every 25th of them
        if mask.shape[0] == B and ((counts["calls"] - 1) // 4) % 25 == 0 \
                and len(recorded) < 64:
            recorded.append((M, q, mask, z0, max_bpp, check_tol))
        z, ok = wrapper(M, q, mask, z0=z0, max_bpp=max_bpp, max_piv=max_piv,
                        check_tol=check_tol)
        work = mask.any(dim=1)
        if pos == 0:
            tally["empty"] += (~work).sum()
        tally[position[pos]] += (ok & work).sum()
        return z, ok

    def recording_sweep(M, q, mask, z0=None, skip=None):
        z, ok = sweep(M, q, mask, z0=z0, skip=skip)
        tally["rescue"] += (ok & ~skip).sum()
        tally["poisoned"] += (~ok & ~skip).sum()
        return z, ok

    # the wrapper counts on the function that `hopper_lcp.bpp_lcp` names, so
    # the stand-in carries the count while it is in place
    recording.launches = 0
    hopper_lcp.bpp_lcp, lcp.lcp_fast_regularized = recording, recording_sweep
    res2 = solve(MPC_ITERS)
    torch.cuda.synchronize()
    hopper_lcp.bpp_lcp, lcp.lcp_fast_regularized = wrapper, sweep
    stages = {k: int(v) for k, v in tally.items()}
    assert counts["calls"] == recording.launches == launches and launches % 4 == 0, (
        counts["calls"], recording.launches, launches)
    # the same solve twice: equal unless a reduction's order changed between
    # the runs, and then within the parity tolerance
    drift = float((res2.cost - res.cost).abs().max())
    assert drift <= MPC_PARITY_RTOL * float(res.cost.mean()), (
        f"mpc: two runs of the same solve differ by {drift:.3e}")
    nonempty = handed // 4 - stages["empty"]
    log(f"[mpc] bpp_lcp launches={launches} a batch solve ({launches // 4} cascades of 4: "
        f"{launches // (4 * MPC_HORIZON)} rollouts of {MPC_HORIZON} steps); problems handed "
        f"to the kernel={handed}; cascades entered with a non-empty mask={nonempty}; the "
        f"second run's costs differ from the first's by {drift:.3e}")
    log(f"[mpc] problems leaving the cascade at each stage: {stages}")
    assert sum(stages.values()) == handed // 4, (stages, handed)
    assert stages["poisoned"] == 0, "mpc: a problem failed every stage of the cascade"
    assert nonempty > 0, "mpc: the kernel never had a problem to solve"

    # ---- launches and device share of a short solve (1 iteration), profiled
    t0 = time.time()
    solve(1)
    torch.cuda.synchronize()
    short = time.time() - t0
    mpc_device_share(lambda: solve(1), short)

    # ---- the hoisted linearization's memory on this task: one iteration
    # each way, peaks from a reset
    peaks = []
    for hoist in (False, True):
        torch.cuda.reset_peak_memory_stats()
        contact_mpc.solve_batch(prob, states, cost, cost_final, n_iters=1,
                                hoist_linearization=hoist, device=DEVICE)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    hoist = hoist_memory("mpc", prob.scene, B, MPC_HORIZON, peaks[1], peaks[0])
    return launches, recorded, B / elapsed, hoist


def mpc_device_share(solve_fn, seconds, tag="mpc", out=None):
    """Where a short solve's time goes: its device time by kernel name
    (torch.profiler, device activity only: a solve is some 10^5 launches)
    against its unprofiled time `seconds` (None: measured later by the
    caller). A reading, not a check: the device seconds and the launches go
    into `out` ("busy", "kernels")."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve_fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages() if ev.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    if busy <= 0:
        log(f"[{tag}] device time per solve: not measured (profiler saw no kernel)")
        return
    n_kernels = sum(r[2] for r in rows)
    if out is not None:
        out.update(busy=busy, kernels=n_kernels)
    share = "" if seconds is None else (
        f" of {seconds * 1e3:.1f} ms (idle share {1.0 - busy / seconds:.3f})")
    log(f"[{tag}] one-iteration solve of the batch: device busy {busy * 1e3:.1f} ms"
        f"{share}, {n_kernels} kernel launches")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms {count:8d} launches  {key[:90]}")


def phase_mpc_parity():
    """Card float32 through the kernel route against the port on the CPU in
    float64 through the batched route, on the same task at a small batch."""
    from moby_tpu_torch.mpc import contact_mpc

    B = MPC_PARITY_BATCH
    out = {}
    for device in (DEVICE, "cpu"):
        prob, states, cost, cost_final = ballpush_task(device, B, 11)
        c0 = contact_mpc.solve_batch(prob, states, cost, cost_final, n_iters=0,
                                     device=device).cost
        res = contact_mpc.solve_batch(prob, states, cost, cost_final,
                                      n_iters=MPC_ITERS, device=device)
        out[device] = (c0.double().cpu(), res.cost.double().cpu())
    (c0_gpu, c_gpu), (c0_cpu, c_cpu) = out[DEVICE], out["cpu"]
    assert c_cpu.dtype == torch.float64
    assert torch.isfinite(c_gpu).all() and torch.isfinite(c_cpu).all()
    assert bool((c_gpu <= c0_gpu).all()) and bool((c_cpu <= c0_cpu).all())
    rel = abs(float(c_gpu.mean()) - float(c_cpu.mean())) / float(c_cpu.mean())
    worst = float(((c_gpu - c_cpu).abs() / c_cpu.abs().clamp_min(1e-12)).max())
    log(f"[mpcparity] B={B}: final mean cost card float32 {float(c_gpu.mean()):.6f}, "
        f"CPU float64 {float(c_cpu.mean()):.6f}: relative difference {rel:.3e} "
        f"(worst member {worst:.3e}); initial mean {float(c0_cpu.mean()):.4f}")
    assert rel <= MPC_PARITY_RTOL, f"mpcparity: mean costs differ by {rel:.3e}"
    return rel

# ---------------------------------------------------------------- block-push
def build_blockpush(device, dtype=None):
    """The block-push scene of `examples/block_push_mpc.py`: a 0.2 m cube of
    1 kg resting on a plane, mu=0.3, nk=4 (8 vertex slots; its QP-KKT LCP has
    n=64, the block path of `bpp_lcp`)."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("block", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
               pos=np.array([0.0, 0.0, 0.2]))
    b.add_geom("block", sc.BOX, [0.2, 0.2, 0.2])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "block", sc.ContactParams(mu_coulomb=0.3, nk=4))
    return b.compile(device=device, dtype=dtype)


def blockpush_task(device, B, seed, dtype=None):
    """The example's task: push the block to BLOCK_TARGET at the end of the
    horizon with small control effort. B scenarios; with a seed, each block
    starts moved in x and y by numpy-drawn jitter in [-BLOCK_JITTER,
    BLOCK_JITTER)."""
    from moby_tpu_torch.mpc import contact_mpc

    scene, st = build_blockpush(device, dtype)
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=BLOCK_DT,
                                  horizon=BLOCK_HORIZON)
    states = st.expand(B)
    if seed is not None:
        d = np.random.default_rng(seed).uniform(-BLOCK_JITTER, BLOCK_JITTER, size=(B, 2))
        pos = states.pos.clone()
        pos[:, 0, :2] += torch.tensor(d, dtype=pos.dtype, device=pos.device)
        states = states.replace(pos=pos)
    target = torch.tensor(BLOCK_TARGET, dtype=st.pos.dtype, device=st.pos.device)

    def cost(x, u):
        return 1e-4 * (u[:, :6] ** 2).sum(dim=1)

    def cost_final(x):
        return 100.0 * ((x[:, 0:2] - target) ** 2).sum(dim=1)

    return prob, states, cost, cost_final


def counting_bpp(record=None, keep=8):
    """A stand-in for `hopper_lcp.bpp_lcp` that tallies on the device (no
    synchronisation) the calls and problems with work, and keeps every 25th
    stage-1 call (the first of each cascade of four) in `record`, up to
    `keep`. The real wrapper counts its launches on the function that
    `hopper_lcp.bpp_lcp` names, so the stand-in carries the count."""
    from moby_tpu_torch.solvers import hopper_lcp

    wrapper = hopper_lcp.bpp_lcp
    tally = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
             for k in ("calls_with_work", "problems_with_work")}

    def call(M, q, mask, z0=None, max_bpp=24, max_piv=None, check_tol=None):
        work = mask.any(dim=1)
        tally["calls_with_work"] += work.any()
        tally["problems_with_work"] += work.sum()
        if record is not None and call.launches % 100 == 0 and len(record) < keep:
            record.append((M, q, mask, z0, max_bpp, check_tol))
        return wrapper(M, q, mask, z0=z0, max_bpp=max_bpp, max_piv=max_piv,
                       check_tol=check_tol)

    call.launches = 0
    hopper_lcp.bpp_lcp = call

    def restore():
        hopper_lcp.bpp_lcp = wrapper
        return {k: int(v) for k, v in tally.items()}

    return call, restore


def phase_block(seed):
    """Block-push MPC on the card: (a) `contact_mpc.solve` at the example's
    own settings, (b) `solve_batch` at BLOCK_BATCH in every mode of
    BLOCK_MODES. Returns what blockparity and the kernel checks need."""
    from moby_tpu_torch.mpc import contact_mpc
    from moby_tpu_torch.solvers import hopper_lcp

    # (a) the example: one scenario, H=30, 12 iterations
    prob, st, cost, cost_final = blockpush_task(DEVICE, 1, None)
    n = prob.scene.n_lcp
    assert st.pos.dtype == torch.float32 and n == 64, n
    for B in (1, 8, 13):
        assert hopper_lcp.launch_plan(n, torch.float32, B).path == "block"
    c0 = float(contact_mpc.solve(prob, st, cost, cost_final, n_iters=0,
                                 device=DEVICE).cost)
    hopper_lcp.bpp_lcp.launches = 0
    t0 = time.time()
    res = contact_mpc.solve(prob, st, cost, cost_final, n_iters=BLOCK_SINGLE_ITERS,
                            device=DEVICE)
    torch.cuda.synchronize()
    single_s = time.time() - t0
    single_launches = hopper_lcp.bpp_lcp.launches
    assert res.xs.shape == (BLOCK_HORIZON + 1, 13) and res.us.shape == (BLOCK_HORIZON, 6)
    assert torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
    cost_a = float(res.cost)
    xy = [float(v) for v in res.xs[-1, :2]]
    log(f"[block] (a) solve, H={BLOCK_HORIZON} dt={BLOCK_DT} iters={BLOCK_SINGLE_ITERS} "
        f"float32 n_lcp={n}: final block xy {xy[0]:.4f} {xy[1]:.4f} (target "
        f"{BLOCK_TARGET}), cost {cost_a:.6f} (initial {c0:.4f}), {single_s:.2f} s, "
        f"bpp_lcp launches {single_launches}")
    assert single_launches > 0, "block: the single solve never launched bpp_lcp"
    assert cost_a < c0, "block: the single solve did not lower the cost"
    assert float(res.xs[:, 2].min()) > 0.2 - 5e-3, "block: the block sank into the plane"

    # (b) solve_batch in every mode
    from moby_tpu_torch.mpc import MPCOptions

    B = BLOCK_BATCH
    prob, states, cost, cost_final = blockpush_task(DEVICE, B, seed)
    c0s = contact_mpc.solve_batch(prob, states, cost, cost_final, n_iters=0,
                                  device=DEVICE).cost
    modes, recorded = {}, []
    for name, kw in BLOCK_MODES:
        kw = dict(kw)
        opts = {}
        if kw.pop("bf16", False):
            opts["riccati_bf16"] = True
        if "block_jac" in kw:
            opts["block_jac"] = kw.pop("block_jac")
        options = MPCOptions(**opts)
        kw["options"] = options

        def solve(n_iters):
            return contact_mpc.solve_batch(prob, states, cost, cost_final,
                                           n_iters=n_iters, device=DEVICE, **kw)

        # the launches and device time of a one-iteration solve (the first
        # call: the profiler reads device time only, so the host's first-call
        # work does not enter); the other modes' timed solve is their first
        busy = {}
        if name in BLOCK_PROFILED:
            mpc_device_share(lambda: solve(1), None, tag=f"block {name}", out=busy)
        # the timed solve: counts to 0 just before, read just after
        call, restore = counting_bpp(recorded if name == "rr" else None)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = solve(BLOCK_ITERS)
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = call.launches
        work = restore()
        peak = torch.cuda.max_memory_allocated()
        chunks = (contact_mpc.hoist_chunks(prob.scene, B, BLOCK_HORIZON, torch.float32,
                                           kw.get("linearize_fwd", False), options)
                  if kw.get("hoist_linearization") else None)
        nan = int((~torch.isfinite(res.cost)).sum())
        worse = int((res.cost > c0s).sum())
        fell = float((res.cost < c0s).double().mean())
        idle = None if busy.get("busy") is None else 1.0 - busy["busy"] / elapsed
        if name in BLOCK_PROFILED:
            log(f"[block {name}] the timed solve: idle share "
                f"{idle if idle is None else round(idle, 3)}, {busy.get('kernels')} "
                f"kernel launches")
        modes[name] = {
            "solves_per_s": B / elapsed, "seconds": elapsed,
            "launches_profiled": busy.get("kernels"), "idle_share": idle,
            "peak_bytes": peak, "hoist_chunks": chunks, "bpp_lcp_launches": launches,
            **work, "nan_costs": nan, "above_start": worse,
            "cost": res.cost.double().cpu(), "options": options,
            "linearize_fwd": kw.get("linearize_fwd", False),
        }
        log(f"[block] (b) {name}: B={B} H={BLOCK_HORIZON} iters={BLOCK_ITERS}: "
            f"{elapsed:.2f} s, {B / elapsed:.1f} solves/s; peak device memory "
            f"{peak / 2 ** 30:.2f} GiB; hoist chunks {chunks}; bpp_lcp launches "
            f"{launches}, with work {work['calls_with_work']} (problems with work "
            f"{work['problems_with_work']}); cost mean {float(res.cost.mean()):.4f} "
            f"(initial {float(c0s.mean()):.4f}), fell for {fell:.3f}, NaN {nan}, "
            f"above start {worse}")
        assert launches > 0, f"block {name}: the solve never launched bpp_lcp"
    for name, twin in (("rr_hoist", "rr"), ("rr_fwd_hoist", "rr_fwd")):
        modes[name]["hoist_memory"] = hoist_memory(
            f"block {name}", prob.scene, B, BLOCK_HORIZON, modes[name]["peak_bytes"],
            modes[twin]["peak_bytes"], modes[name]["linearize_fwd"],
            modes[name]["options"])
    return {"single": {"cost": cost_a, "xy": xy, "seconds": single_s, "c0": c0,
                       "launches": single_launches},
            "c0": c0s.double().cpu(), "modes": modes, "recorded": recorded,
            "launches": single_launches + sum(m["bpp_lcp_launches"]
                                              for m in modes.values())}


def block_riccati_inputs(device, B, seed):
    """Inputs of the Riccati check at one state of block-push: a jittered
    block at rest pushed by seeded controls (x/y up to 2 N, torques up to
    0.2 N·m), float32, and rr's step Jacobians there (`ilqr._jacobians`
    through the replay of the recorded LCP solution). -> (A, Bm, x1, u)."""
    from moby_tpu_torch.mpc import contact_mpc, ilqr

    prob, states, _, _ = blockpush_task(device, B, seed, torch.float32)
    scene = prob.scene
    _, f_rec, f_rep = contact_mpc.make_dynamics_rr(scene, prob.template, prob.dt)
    rng = np.random.default_rng(seed + 1)
    u = torch.zeros(B, 6, dtype=torch.float32, device=device)
    u[:, :2] = torch.tensor(rng.uniform(-2.0, 2.0, size=(B, 2)), dtype=u.dtype)
    u[:, 3:] = torch.tensor(rng.uniform(-0.2, 0.2, size=(B, 3)), dtype=u.dtype)
    x0 = contact_mpc.pack(scene, states)
    with torch.no_grad():
        x1, z0, _ = f_rec(x0, u, f_rec.aux_init(B))
    A, Bm = ilqr._jacobians(f_rep, x0, u, z0)
    return A, Bm, x1, u


def riccati_outputs(A, Bm, x1, u, bf16):
    """Two steps of `ilqr._riccati_step` from block-push's terminal value at
    x1 (cost_final's gradient and Hessian) through (A, Bm), with the running
    cost's derivatives at u: -> the second step's (Vx, Vxx, k, K)."""
    from moby_tpu_torch.mpc import ilqr

    Bn, nx = x1.shape
    nu = u.shape[1]
    t = torch.tensor(BLOCK_TARGET, dtype=x1.dtype, device=x1.device)
    Vx = torch.zeros_like(x1)
    Vx[:, :2] = 200.0 * (x1[:, :2] - t)
    Vxx = torch.zeros(Bn, nx, nx, dtype=x1.dtype, device=x1.device)
    Vxx[:, 0, 0] = Vxx[:, 1, 1] = 200.0
    eye = torch.eye(nu, dtype=x1.dtype, device=x1.device).expand(Bn, nu, nu)
    cx, cxx = torch.zeros_like(x1), torch.zeros_like(Vxx)
    cu, cuu = 2e-4 * u, 2e-4 * eye
    cux = x1.new_zeros(Bn, nu, nx)
    mus = x1.new_full((Bn,), 1e-6)
    for _ in range(2):
        Vx, Vxx, ok, _, _, k, K = ilqr._riccati_step(
            Vx, Vxx, A, Bm, cx, cu, cxx, cuu, cux, mus, riccati_bf16=bf16)
        assert bool(ok.all()), "riccati: a Quu was not positive definite"
    return Vx, Vxx, k, K


def rel_max(a, b):
    """max |a - b| over max |b|, in float64 on the CPU."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_block_parity(block):
    """The limits of BLOCK_TARGET_DIST ... BLOCK_RICCATI_RTOL (see there):
    (a)'s card solve leaves the block at the target; every mode of (b)
    against rr after one iteration from the shared start, and bf16's
    Riccati step card float32 against CPU float64. Printed beside them:
    (a) against the port's CPU float64 solve, (b)'s final costs against
    rr's."""
    from moby_tpu_torch.mpc import contact_mpc

    prob, st, cost, cost_final = blockpush_task("cpu", 1, None)
    assert st.pos.dtype == torch.float64
    t0 = time.time()
    res = contact_mpc.solve(prob, st, cost, cost_final, n_iters=BLOCK_SINGLE_ITERS,
                            device="cpu")
    c_cpu, c_gpu = float(res.cost), block["single"]["cost"]
    xy_cpu = [float(v) for v in res.xs[-1, :2]]
    dist = float(np.hypot(*np.subtract(block["single"]["xy"], BLOCK_TARGET)))
    dist_cpu = float(np.hypot(*np.subtract(xy_cpu, BLOCK_TARGET)))
    log(f"[blockparity] (a) the card's block ends {dist * 1e3:.2f} mm from the target "
        f"(limit {BLOCK_TARGET_DIST * 1e3:.0f} mm), the CPU float64 solve's "
        f"{dist_cpu * 1e3:.2f} mm; readings: cost card float32 {c_gpu:.6f}, CPU float64 "
        f"{c_cpu:.6f} ({time.time() - t0:.1f} s), |card - CPU| / CPU = "
        f"{abs(c_gpu - c_cpu) / c_cpu:.3e}")
    assert dist <= BLOCK_TARGET_DIST, f"blockparity: (a) the block ends {dist:.4f} m off"
    out = {"single_target_dist": dist, "single_cost_rel": abs(c_gpu - c_cpu) / c_cpu}
    ref = block["modes"]["rr"]["cost"]
    for name, m in block["modes"].items():
        assert m["nan_costs"] == 0, f"blockparity: {name} has {m['nan_costs']} NaN costs"
        assert m["above_start"] == 0, (
            f"blockparity: {name} has {m['above_start']} members above their start")
        if name == "rr":
            continue
        one = float(((m["cost"] - ref).abs() / ref.abs()).median())
        out[name] = one
        held = name != "rr_bf16"
        log(f"[blockparity] (b) {name}: {BLOCK_ITERS} iteration, median |c - c_rr| / "
            f"|c_rr| = {one:.3e}" + (f" (limit {BLOCK_MODE_RTOL})" if held else
                                     " (a reading)")
            + f"; mean cost {float(m['cost'].mean()):.4f} against rr's "
            f"{float(ref.mean()):.4f}")
        if held:
            assert one <= BLOCK_MODE_RTOL, f"blockparity: {name} off rr by {one:.3e}"
    # bf16's Riccati step at one shared state, card against CPU float64
    A, Bm, x1, u = block_riccati_inputs(DEVICE, BLOCK_RICCATI_BATCH, 3)
    names = ("Vx", "Vxx", "k", "K")
    for bf16 in (False, True):
        card = riccati_outputs(A, Bm, x1, u, bf16)
        cpu = riccati_outputs(*(t.double().cpu() for t in (A, Bm, x1, u)), bf16)
        errs = {k: rel_max(c, w) for k, c, w in zip(names, card, cpu)}
        out[f"riccati_bf16={bf16}"] = max(errs.values())
        log(f"[blockparity] Riccati step, riccati_bf16={bf16}, B={BLOCK_RICCATI_BATCH}: card "
            f"float32 against CPU float64, max difference over max entry {errs} (limit "
            f"{BLOCK_RICCATI_RTOL})")
        assert max(errs.values()) <= BLOCK_RICCATI_RTOL, (
            f"blockparity: the Riccati step (bf16={bf16}) is off by {errs}")
        if bf16:
            plain = riccati_outputs(*(t.double().cpu() for t in (A, Bm, x1, u)), False)
            gap = rel_max(cpu[3], plain[3])
            log(f"[blockparity] the bfloat16 rounding moves K by {gap:.3e} of its scale")
            assert gap > 10 * BLOCK_RICCATI_RTOL, (
                "blockparity: the check cannot tell the bf16 step from the plain one")
    return out


def hoist_memory(tag, scene, B, H, peak_hoisted, peak_plain, linearize_fwd=False,
                 options=None):
    """The hoisted linearization's device memory above its unhoisted twin's
    peak, beside the memory model of `contact_mpc.hoist_chunks`: fails when
    it passes the model's budget. Returns the reading."""
    from moby_tpu_torch.mpc import contact_mpc

    options = options or contact_mpc.DEFAULT_OPTIONS
    chunks = contact_mpc.hoist_chunks(scene, B, H, torch.float32, linearize_fwd, options)
    reps, per_step = contact_mpc.hoist_step_bytes(scene, B, torch.float32,
                                                  linearize_fwd, options)
    steps = -(-H // chunks)
    extra = peak_hoisted - peak_plain
    out = {"chunks": chunks, "extra_bytes": extra, "model_bytes": steps * per_step,
           "measured_bytes_per_replica": extra / (steps * reps),
           "model_bytes_per_replica": per_step / reps}
    log(f"[{tag}] hoisted linearization: {chunks} chunk(s) of {steps} steps, "
        f"{steps * reps} replicas of the n={scene.n_lcp} step; peak {peak_hoisted / 2 ** 30:.2f} "
        f"GiB against {peak_plain / 2 ** 30:.2f} GiB unhoisted: {extra / 2 ** 30:.2f} GiB more, "
        f"{out['measured_bytes_per_replica']:.0f} B a replica; the model's "
        f"{out['model_bytes'] / 2 ** 30:.2f} GiB ({out['model_bytes_per_replica']:.0f} B a "
        f"replica) under a budget of {contact_mpc.HOIST_BUDGET_BYTES / 2 ** 30:.0f} GiB")
    assert extra <= contact_mpc.HOIST_BUDGET_BYTES, f"{tag}: the hoist passed its budget"
    return out


def phase_kernels_block(block):
    """`bpp_lcp` against `bpp_lcp_plain` on block-push's recorded n=64 LCPs
    (stage-1 calls of the rr mode's timed solve), float32 as recorded and
    float64: by the velocity change in the QP's variables (z is not unique:
    four coplanar contacts; `check_qp_velocity_case`), and by z on
    M + 0.05·I. Also how many of their problems reach the PPM stage. Returns
    the largest z error."""
    from moby_tpu_torch.solvers import hopper_lcp

    work = [r for r in block["recorded"] if bool(r[2].any())]
    picks = work[:1]
    assert picks, "block: no recorded call had a problem with work"
    scene = build_blockpush("cpu")[0]
    nv = 5 * scene.n_contacts + scene.n_limits      # x = [cn, cs, ct, ncs, nct, l]
    worst = 0.0
    reach = {"calls": len(work), "with_work": 0, "ppm": 0}
    for (M, q, mask, z0, mb, tol) in work:
        _, _, its, piv, _ = hopper_lcp.bpp_lcp_plain(M, q, mask, z0=z0, max_bpp=mb,
                                                     check_tol=tol, with_pivots=True)
        has_work = mask.any(dim=1)
        reach["with_work"] += int(has_work.sum())
        reach["ppm"] += int((has_work & (piv > 0)).sum())
    for dtype in (torch.float32, torch.float64):
        def cast(t):
            return None if t is None else t.to(dtype).contiguous()

        for i, (M, q, mask, z0, mb, tol) in enumerate(picks):
            M, q, z0 = cast(M), cast(q), cast(z0)
            kw = dict(max_bpp=mb) if dtype == torch.float64 else dict(max_bpp=mb,
                                                                       check_tol=tol)
            check_qp_velocity_case(f"block-push call {i} as handed", M, q, mask, z0,
                                   nv, **kw)
            Mr = (M + 0.05 * torch.diag_embed(mask.to(dtype))).contiguous()
            e, _, _ = check_case(f"block-push call {i} + 0.05 I", Mr, q, mask, z0,
                                 solver="bpp", max_bpp=mb)
            worst = max(worst, e)
    log(f"[kernels] block-push: of {reach['with_work']} problems with work in "
        f"{len(work)} recorded stage-1 calls, {reach['ppm']} reached the PPM stage")
    block["ppm_reach"] = reach
    return worst


# ---------------------------------------------------------- articulated MPC
def double_pendulum(device, dtype=None):
    """The double pendulum of `examples/double_pendulum.py` (two 1 m rods of
    1 kg on revolute joints about z, gravity along -y), its first joint
    limited to [0.5, 3.0] as in the repo's limited-pendulum tests."""
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.dynamics import model as mdl

    def link(name, parent_r, lo=None, hi=None):
        j = mdl.JointDef(jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=parent_r,
                         axis=np.array([0.0, 0, 1]),
                         lo=None if lo is None else np.array([lo]),
                         hi=None if hi is None else np.array([hi]))
        return mdl.LinkDef(name=name, mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                           inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]), joint=j)

    m = mdl.ArticulatedModel([link("l1", np.zeros(3), lo=0.5, hi=3.0),
                              link("l2", np.array([0.0, -1.0, 0.0]))], floating=False)
    m.set_parents([-1, 0])
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("dp", m, q0=np.array([0.5, 0.0]))
    return b.compile(device=device, dtype=dtype)


def phase_art_mpc(seed):
    """The articulated MPC step on the card at ART_MPC_BATCH: `dstep` (through
    `make_dynamics`), the `_jacobians` linearization and the block
    linearizer `f_jac` (forward mode over u: the scene is articulated), card
    float32 against the port on the CPU in float64. Every scenario starts
    past the first joint's stop and moving into it, so the limit rows of the
    LCP have work."""
    from moby_tpu_torch.mpc import contact_mpc, ilqr
    from moby_tpu_torch.solvers import hopper_lcp

    B = ART_MPC_BATCH
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.45, 0.49, B), rng.normal(0.3, 0.5, B),
                  rng.uniform(-1.0, -0.1, B), rng.normal(0.0, 1.0, B)], axis=1)
    u = rng.normal(0.0, 3.0, (B, 2))
    out = {}
    for device in (DEVICE, "cpu"):
        scene, st = double_pendulum(device)
        f, f_rec, f_rep = contact_mpc.make_dynamics_rr(scene, st, ART_MPC_DT)
        xt = torch.tensor(x, dtype=st.q_art.dtype, device=device)
        ut = torch.tensor(u, dtype=st.q_art.dtype, device=device)
        hopper_lcp.bpp_lcp.launches = 0
        y = f(xt, ut)
        A, Bm = ilqr._jacobians(f, xt, ut)
        _, z, _ = f_rec(xt, ut, f_rec.aux_init(B))
        Aj, Bj = f_rep.jac(xt, ut, z)
        if device == DEVICE:
            torch.cuda.synchronize()
            launches = hopper_lcp.bpp_lcp.launches
        out[device] = [t.double().cpu() for t in (y, A, Bm, Aj, Bj, z)]
    gpu, cpu = out[DEVICE], out["cpu"]
    assert all(bool(torch.isfinite(t).all()) for t in gpu)
    assert float(cpu[5].abs().max()) > 1e-3, "artmpc: the limit did not act"
    errs = {"dstep": float((gpu[0] - cpu[0]).abs().max())}
    for i, name in enumerate(("A", "B", "f_jac A", "f_jac B"), start=1):
        errs[name] = float((gpu[i] - cpu[i]).abs().max()) / float(cpu[i].abs().max())
    log(f"[artmpc] limited double pendulum B={B} dt={ART_MPC_DT}, n_lcp="
        f"{double_pendulum('cpu')[0].n_lcp}: card float32 against CPU float64, max "
        f"differences (the step absolute, the Jacobians relative to their largest "
        f"entry) {errs}; bpp_lcp launches {launches}; limit impulses "
        f"up to {float(cpu[5].abs().max()):.3f}")
    assert launches > 0, "artmpc: the step never launched bpp_lcp"
    assert errs["dstep"] <= ART_MPC_TOL["dstep"], errs
    for name in ("A", "B", "f_jac A", "f_jac B"):
        assert errs[name] <= ART_MPC_TOL["jacobian"], errs
    return errs


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


# ------------------------------------------------------------- articulated
def table_states(device, B, seed, dtype=None):
    """The repo's table scene loaded by the port's `mobyxml.load` on
    `device`: B scenarios whose spin ω_z (the floating base's qd[2], 1.0 in
    the scene) is drawn by numpy from `seed` in [0.9, 1.1] rad/s. Heights
    are not jittered: the legs start in contact."""
    from moby_tpu_torch.io import mobyxml

    scene, st, _ = mobyxml.load(TABLE_XML, device=device, dtype=dtype)
    wz = np.random.default_rng(seed).uniform(0.9, 1.1, size=B)
    st = st.expand(B)
    qd = st.qd_art.clone()
    qd[:, 2] = torch.tensor(wz, dtype=qd.dtype, device=qd.device)
    return scene, st.replace(qd_art=qd)


def phase_art(seed):
    """The articulated main path: ART_BATCH table scenarios through
    `stepper.step` on the card. Returns what the timing and the kernel
    checks need."""
    from moby_tpu_torch.sim import noslip, stabilization, stepper
    from moby_tpu_torch.solvers import hopper_lcp, lcp

    B, n_steps = ART_BATCH, ART_STEPS
    scene, st = table_states(DEVICE, B, seed)
    n = scene.n_contacts + scene.n_limits
    assert st.q_art.dtype == torch.float32 and scene.use_noslip and n == 40
    plan = hopper_lcp.launch_plan(n, torch.float32, B)
    for _ in range(ART_WARMUP):                       # not counted
        st = stepper.step(scene, st, ART_DT, device=DEVICE)
    torch.cuda.synchronize()

    # stand-ins for the run: what the path hands the kernel and from which
    # LCP, what enters `_solve_accel`, and where the problems leave it
    # (device counters, read after the run)
    recorded, entered_lcps = [], []
    origin = {"lcp": "?"}
    tally = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
             for k in ("entered", "empty", "stage1", "stage2+3", "stage3", "failed")}
    saved = (hopper_lcp.ppm_lcp, lcp._solve_accel, lcp._solve_fast_lemke_plain,
             noslip.solve_noslip, stabilization.stabilize, lcp.solve_principal)
    wrapper, accel, plain, solve_ns, stab, principal = saved
    subsolves = []

    def recording(M, q, mask, z0=None, max_piv=None):
        recorded.append((origin["lcp"], M, q, mask, z0))
        return wrapper(M, q, mask, z0=z0, max_piv=max_piv)

    def recording_accel(M, q, mask, z0, skip, plain_fallback):
        z, ok, stats = accel(M, q, mask, z0, skip, plain_fallback)
        entered = ~lcp._no_skip(skip, q)
        work = entered & mask.any(dim=1)
        entered_lcps.append((origin["lcp"], M, q, mask & entered[:, None], z0))
        tally["entered"] += entered.sum()
        tally["empty"] += (entered & ~work).sum()
        tally["stage1"] += (work & ~stats.fallback).sum()
        tally["stage2+3"] += (work & stats.fallback & ok).sum()
        tally["failed"] += (entered & ~ok).sum()
        return z, ok, stats

    def counting_principal(M, rhs, nonbas):
        subsolves.append(M.shape)
        return principal(M, rhs, nonbas)

    def recording_plain(M, q, mask, z0=None, skip=None, with_stats=False):
        out = plain(M, q, mask, z0, skip, with_stats)
        tally["stage3"] += (out[1] & ~lcp._no_skip(skip, q)).sum()
        return out

    def tagged(name, fn):
        def call(*a, **kw):
            origin["lcp"] = name
            out = fn(*a, **kw)
            origin["lcp"] = "?"
            return out
        return call

    # the wrapper counts on the function that `hopper_lcp.ppm_lcp` names, so
    # the stand-in carries the count while it is in place
    hopper_lcp.ppm_lcp = recording
    lcp._solve_accel = recording_accel
    lcp._solve_fast_lemke_plain = recording_plain
    noslip.solve_noslip = tagged("noslip", solve_ns)
    stabilization.stabilize = tagged("stabilization", stab)
    lcp.solve_principal = counting_principal
    recording.launches = 0
    hopper_lcp.bpp_lcp.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    for _ in range(n_steps):
        st = stepper.step(scene, st, ART_DT, device=DEVICE)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = recording.launches
    (hopper_lcp.ppm_lcp, lcp._solve_accel, lcp._solve_fast_lemke_plain,
     noslip.solve_noslip, stabilization.stabilize, lcp.solve_principal) = saved
    peak = torch.cuda.max_memory_allocated()
    assert hopper_lcp.bpp_lcp.launches == 0    # the step's cascade has no bpp_lcp stage

    for name in ("q_art", "qd_art", "zlast"):
        assert torch.isfinite(getattr(st, name)).all(), f"art: {name} not finite"
    qa, qd = st.q_art.double(), st.qd_art.double()
    slide = float(qa[:, :2].abs().max())
    sink = float((qa[:, 2] - 1.05).abs().max())
    speed = float(qd.abs().max())
    log(f"[art] B={B} steps={n_steps} dt={ART_DT} float32 (table, n_lcp={n}): "
        f"{elapsed:.2f} s, {B * n_steps / elapsed:.1f} scenario-steps/s, "
        f"{n_steps / elapsed:.2f} batch-steps/s")
    log(f"[art] at rest: base slid {slide:.3e} m, height off {sink:.3e} m, "
        f"largest |qd| {speed:.3e}")
    assert slide < 1e-3 and sink < 1e-3, "art: the table moved off its legs"
    assert speed < 5e-2, "art: the table did not come to rest"
    assert launches > 0, "art: the path never launched ppm_lcp"
    assert len(recorded) == launches

    nonempty = {"noslip": 0, "stabilization": 0}
    handed = 0
    for (who, _, _, m, _) in recorded:
        nonempty[who] += int(m.any(dim=1).sum())
        handed += m.shape[0]
    stages = {k: int(v) for k, v in tally.items()}
    stages["stage2"] = stages.pop("stage2+3") - stages["stage3"]
    entered = stages.pop("entered")
    assert sum(stages.values()) == entered, (stages, entered)
    log(f"[art] ppm_lcp launches={launches} ({launches / n_steps:.2f} a step), "
        f"problems handed to the kernel={handed}, with a non-empty mask="
        f"{sum(nonempty.values())} ({nonempty}); n={n}, path={plan.path} "
        f"(grid {plan.grid}, {plan.smem} bytes of shared memory a block)")
    log(f"[art] LCP problems entering _solve_accel={entered}, leaving at: {stages}")
    log(f"[art] peak device memory {peak / 2 ** 20:.1f} MiB, of which the run "
        f"added {(peak - mem0) / 2 ** 20:.1f} MiB (its recorded LCPs included)")
    device_share(lambda: stepper.step(scene, st, ART_DT, device=DEVICE),
                 elapsed / n_steps, tag="art")
    # the sub-solves of the pivoting LCP stages (Gauss–Jordan in float32):
    # how many a step, and the launches and device time of one
    _, Ms, qs, ms_, _ = recorded[0]
    full = torch.ones_like(ms_)
    k, us = launches_of(lambda: lcp.solve_principal(Ms, -qs, full))
    log(f"[art] pivoting sub-solves (lcp.solve_principal, float32 Gauss-Jordan at "
        f"B={B} n={n}): {len(subsolves) / n_steps:.1f} a step; one takes {k} "
        f"kernel launches and {us / 1e3:.3f} ms of device time")
    return {"launches": launches, "recorded": recorded, "entered": entered_lcps,
            "rate": B * n_steps / elapsed, "nonempty": sum(nonempty.values()),
            "stages": stages, "plan": plan, "peak_bytes": peak}


def launches_of(fn):
    """(kernel launches, device µs) of one call of fn, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0]
    return sum(ev.count for ev in rows), sum(ev.self_device_time_total for ev in rows)


def check_velocity_case(name, M, q, mask, z0, verify=True):
    """Kernel against plain version on the table's LCPs, whose z is not
    unique (redundant contacts: the no-slip LCP is singular to working
    precision, so pivot ties are decided by rounding and a chain that ends
    done in one version can run into the pivot cap in the other): every
    problem either version calls done satisfies complementarity, some
    problem with work is done in both when either is done on one, and where
    both are done the velocity change M·z they give agrees within
    KKT_VELOCITY_TOL (M·z is unique for these symmetric PSD matrices).
    `verify` goes to `both_versions`; with "as_plain" "done" reads "done and
    complementary" here (on the mesh stack's singular stabilization LCPs the
    two versions' done sets can be disjoint, every one of them failing
    complementarity: there is then no solution to compare). Returns the
    velocity error."""
    from moby_tpu_torch.solvers import lcp

    zk, dk, zp, dp, _ = both_versions(name, M, q, mask, z0, verify)
    n_diff = int((dk != dp).sum())
    work = mask.any(dim=1)
    if verify == "as_plain":
        dk = dk & verified(M, q, mask, zk)
        dp = dp & verified(M, q, mask, zp)
    both = dk & dp & work
    assert bool(both.any()) or not bool(((dk | dp) & work).any()), (
        f"{name}: no problem with work is done in both versions")
    Mp, _ = lcp.pad_lcp(M, q, mask)
    dv = torch.where(mask, (Mp @ (zk - zp)[..., None])[..., 0], 0.0)
    err = float(dv[both].abs().max()) if bool(both.any()) else 0.0
    scale = max(1.0, float(torch.where(mask, q, 0.0).abs().max()))
    log(f"[kernels] {name:44s} {str(M.dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
        f"with work={int(mask.any(dim=1).sum())} done kernel={int(dk.sum())} "
        f"plain={int(dp.sum())} differ={n_diff}: M·z err={err:.3e} (scale {scale:.3g})")
    assert err <= KKT_VELOCITY_TOL[M.dtype] * scale, (
        f"{name}: velocity change differs by {err:.3e}")
    return err


def check_qp_velocity_case(name, M, q, mask, z0, nv, solver="bpp", verify=True, **kw):
    """`bpp_lcp` against `bpp_lcp_plain` (or `ppm_lcp` against
    `ppm_lcp_plain`, `solver="ppm"`) on block-push's QP-KKT LCPs
    [[H, -Gᵀ], [G, 0]] (x = z[:nv] the QP's nonnegative impulse variables,
    H = DᵀAD with A the Delassus matrix), whose z is not unique: four
    coplanar contacts, so pivot ties are decided by rounding. Every problem
    either version calls done satisfies complementarity; in float32, the
    card's dtype, both call the same problems done; where both are done, the
    velocity change in the QP's variables, H·x (unique for exact solutions
    of a convex QP, where the multiplier rows of M·z are not), must agree
    within 2·sqrt(‖M‖∞·ztol·‖z‖∞), the spread of two bases accepted at the
    pivoting's zero tolerance ztol = m·‖M‖∞·eps. For `ppm_lcp` `done` may
    differ on up to 15% of the batch, as on the stack's KKT problems
    (`check_kkt_case`). In float64 `bpp_lcp`'s `done` is read,
    not held: whether a problem finishes is decided by rounding there, as a
    pivot of the singular system is exactly 0 in one elimination and about
    1e-17·‖M‖∞ in the other (tests/test_torch_mpc_single.py::
    test_blockpush_float64_done_is_decided_by_rounding). `verify` goes to
    `both_versions`; with "as_plain" H·x is compared where both versions are
    done and complementary. Returns the largest ratio of the difference to
    the bound."""
    from moby_tpu_torch.solvers import lcp

    zk, dk, zp, dp, _ = both_versions(name, M, q, mask, z0, verify, solver=solver, **kw)
    both = dk & dp & mask.any(dim=1)
    if verify == "as_plain":
        both = both & verified(M, q, mask, zk) & verified(M, q, mask, zp)
    n_diff = int((dk != dp).sum())
    if solver == "ppm":
        # PPM's first-minimum rule meets the mirrored friction columns' ties
        # (check_kkt_case's rule)
        assert n_diff <= 0.15 * len(dk), (
            f"{name}: done differs on {n_diff} of {len(dk)} problems")
    elif M.dtype == torch.float32:
        assert n_diff == 0, f"{name}: done differs on {n_diff} of {len(dk)} problems"
    Mp, _ = lcp.pad_lcp(M, q, mask)
    dv = (Mp[:, :nv, :nv] @ (zk - zp)[:, :nv, None])[..., 0].abs().amax(dim=1)
    nrm = lcp._masked_norm_inf(Mp, mask)
    ztol = mask.sum(dim=1) * nrm * torch.finfo(M.dtype).eps
    zmax = torch.maximum(zk.abs().amax(dim=1), zp.abs().amax(dim=1))
    bound = 2.0 * torch.sqrt(nrm * ztol * zmax).clamp_min(torch.finfo(M.dtype).tiny)
    if not bool(both.any()):
        log(f"[kernels] {name:44s} {str(M.dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
            f"done kernel={int(dk.sum())} plain={int(dp.sum())}: none done in both")
        return 0.0
    ratio = float((dv / bound)[both].max())
    full = float((Mp @ (zk - zp)[..., None])[..., 0].abs().amax(dim=1)[both].max())
    log(f"[kernels] {name:44s} {str(M.dtype)[6:]:8s} B={M.shape[0]} n={M.shape[1]} "
        f"done kernel={int(dk.sum())} plain={int(dp.sum())} differ={n_diff}: "
        f"H·x err={float(dv[both].max()):.3e}, {ratio:.3f} of its bound (median bound "
        f"{float(bound[both].median()):.3e}); M·z err={full:.3e}")
    assert ratio <= 1.0, f"{name}: H·x differs by {ratio:.3f} of its bound"
    return ratio


def phase_kernels_art(art):
    """`ppm_lcp` against `ppm_lcp_plain` on the LCPs the table path recorded
    (n = 40, the block path), float32 as recorded and float64: the calls as
    the cascade handed them to the kernel, and the LCPs as they entered
    `_solve_accel` (every problem with work, cold), by the velocity change;
    the same LCPs made strictly monotone (+0.05·I on the active block) by z.
    Returns the largest z error."""
    handed = [r for r in art["recorded"] if bool(r[3].any())][:4]
    full = [r for who in ("noslip", "stabilization")
            for r in [r for r in art["entered"] if r[0] == who and bool(r[3].any())][:2]]
    assert full, "art: no LCP with work entered the cascade"
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        def cast(t):
            return None if t is None else t.to(dtype).contiguous()

        for (who, M, q, mask, z0) in handed:
            check_velocity_case(f"table {who} as handed", cast(M), cast(q),
                                mask.contiguous(), cast(z0))
        for (who, M, q, mask, z0) in full:
            M, q, mask = cast(M), cast(q), mask.contiguous()
            check_velocity_case(f"table {who} LCPs cold", M, q, mask, None)
            Mr = (M + 0.05 * torch.diag_embed(mask.to(dtype))).contiguous()
            e, _, _ = check_case(f"table {who} LCPs + 0.05 I cold", Mr, q, mask, None)
            worst = max(worst, e)
    return worst


def pendulum_model(lo=None, hi=None):
    """A 1 m rod of 1 kg on a revolute joint about z, hanging along -y at
    q = 0, optionally limited to [lo, hi] (the repo's articulated tests'
    pendulum)."""
    from moby_tpu_torch.dynamics import model as mdl

    j = mdl.JointDef(
        jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=np.zeros(3),
        axis=np.array([0.0, 0, 1]),
        lo=None if lo is None else np.array([lo]),
        hi=None if hi is None else np.array([hi]),
    )
    link = mdl.LinkDef(name="rod", mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                       inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]), joint=j)
    m = mdl.ArticulatedModel([link], floating=False)
    m.set_parents([-1])
    return m


def limited_pendulum(device, B):
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("pend", pendulum_model(lo=0.5, hi=3.0), q0=np.array([1.0]))
    scene, st = b.compile(device=device)
    return scene, st.expand(B)


def phase_art_parity(seed):
    """Card float32 against the port on the CPU in float64 (plain cascade):
    the table and the limited pendulum."""
    from moby_tpu_torch.sim import stepper

    B = ART_PARITY_BATCH
    qa = {}
    for device in (DEVICE, "cpu"):
        scene, st = table_states(device, B, seed + 1)
        _, (_, _, q) = stepper.rollout(scene, st, ART_DT, ART_PARITY_STEPS,
                                       device=device)
        qa[device] = q.double().cpu()
    assert qa["cpu"].dtype == torch.float64 and torch.isfinite(qa[DEVICE]).all()
    drift = (qa[DEVICE] - qa["cpu"]).abs().amax(dim=(1, 2))
    d02 = float(drift[ART_PARITY_STEPS - 1])
    log(f"[artparity] table B={B} steps={ART_PARITY_STEPS}: max |q_art| drift "
        f"{d02:.3e} at {ART_PARITY_STEPS * ART_DT:.1f} s (largest over the run "
        f"{float(drift.max()):.3e}, at "
        f"10 steps {float(drift[9]):.3e})")
    assert d02 < ART_DRIFT_LIMIT, f"artparity: table drift {d02:.3e} at the end"

    qp = {}
    for device in (DEVICE, "cpu"):
        scene, st = limited_pendulum(device, B)
        _, (_, _, q) = stepper.rollout(scene, st, ART_DT, PEND_STEPS, device=device)
        qp[device] = q.double().cpu()[..., 0]
    assert torch.isfinite(qp[DEVICE]).all()
    qmin = {d: float(v.min()) for d, v in qp.items()}
    pdrift = float((qp[DEVICE] - qp["cpu"]).abs().max())
    log(f"[artparity] limited pendulum B={B} steps={PEND_STEPS}: min q card "
        f"{qmin[DEVICE]:.6f}, CPU {qmin['cpu']:.6f} (stop at 0.5), max |q| drift "
        f"{pdrift:.3e}")
    assert qmin[DEVICE] > PEND_MIN_Q and qmin["cpu"] > PEND_MIN_Q, (
        f"artparity: the pendulum passed its stop ({qmin})")
    assert qmin["cpu"] < 0.52, "artparity: the pendulum never reached its stop"
    assert pdrift < PEND_DRIFT_LIMIT, f"artparity: pendulum drift {pdrift:.3e}"
    return d02, pdrift


# ------------------------------------------------------ other contact models
def make_mixed():
    """Three impact models in one step (tests/test_mixed_models.py builds its
    islands so): the stack with nk=4 (the QP), a sphere of radius 0.5 with
    mu=200 (the no-slip MLCP) and one with nk=0 (the NQP), each sliding at
    1 m/s on the plane, 10 m apart, their pairs with the other islands
    disabled."""
    from moby_tpu_torch.core import scene as sc

    b = make_stack(nk=4)
    extra = {"noslip": sc.ContactParams(mu_coulomb=200.0, nk=4),
             "truecone": sc.ContactParams(mu_coulomb=0.5, nk=0)}
    for i, (n, cp) in enumerate(extra.items()):
        b.add_body(n, mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
                   pos=np.array([10.0 * (i + 1), 0.0, 0.5]),
                   lin_vel=np.array([1.0, 0.0, 0.0]))
        b.add_geom(n, sc.SPHERE, [0.5])
        b.set_contact_params("ground", n, cp)
        for other in ("sph1", "sph2", "sph3") + tuple(extra)[:i]:
            b.disabled_pairs.add(tuple(sorted((n, other))))
    return b


def make_chain(n=6, r=0.2, height=0.199):
    """`n` spheres of radius r laid along +x from a disabled anchor at
    `height` (1 mm into the plane, mu=0.5, nk=4), each joined to the next
    (the first to the anchor) by a point constraint: bilateral rows and
    contact in one impact problem. Neighbours touch at their joint, so
    their pair is disabled."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("anchor", enabled=False, pos=np.array([0.0, 0.0, height]))
    names = [f"c{i}" for i in range(n)]
    for i, nm in enumerate(names):
        b.add_body(nm, mass=0.5, inertia=sc.sphere_inertia(0.5, r),
                   pos=np.array([(2 * i + 1) * r, 0.0, height]))
        b.add_geom(nm, sc.SPHERE, [r])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    prev, prev_anchor = "anchor", [0.0, 0.0, 0.0]
    for i, nm in enumerate(names):
        b.set_contact_params("ground", nm, cp)
        for other in names[i + 1:]:
            b.set_contact_params(nm, other, cp)
        b.add_point_constraint(prev, prev_anchor, nm, [-r, 0.0, 0.0])
        if i:
            b.disabled_pairs.add(tuple(sorted((prev, nm))))
        prev, prev_anchor = nm, [r, 0.0, 0.0]
    return b


def make_gear_pendulum(ratio=2.0):
    """A double pendulum (two 1 m rods of 1 kg on revolute joints about z,
    gravity along -y) whose joints a gear couples: qd_l1 = ratio·qd_l2."""
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.dynamics import model as mdl

    def link(name, parent_r):
        j = mdl.JointDef(jtype=mdl.REVOLUTE, Xt_E=np.eye(3), Xt_r=parent_r,
                         axis=np.array([0.0, 0, 1]))
        return mdl.LinkDef(name=name, mass=1.0, com=np.array([0.0, -0.5, 0.0]),
                           inertia_com=np.diag([1.0 / 12, 1e-12, 1.0 / 12]),
                           joint=j)

    m = mdl.ArticulatedModel(
        [link("l1", np.zeros(3)), link("l2", np.array([0.0, -1.0, 0.0]))],
        floating=False)
    m.set_parents([-1, 0])
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    b.add_articulated("gp", m, q0=np.array([0.6, 0.3]),
                      qd0=np.array([0.0, 0.0]))
    b.add_gear_constraint("gp", "l1", "l2", ratio)
    return b


def make_planar_box():
    """A 0.2 m box held in the x-z plane by a planar joint to the disabled
    ground (an ImplicitConstraint of a PlanarJoint, normal along y), spinning
    about x and sliding as it lands on the plane (mu=0.4, nk=4)."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("box", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
               pos=np.array([0.0, 0.5, 0.2005]), lin_vel=np.array([0.5, 0.1, -0.3]),
               ang_vel=np.array([3.0, 0.0, 0.0]))
    b.add_geom("box", sc.BOX, [0.2, 0.2, 0.2])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "box", sc.ContactParams(mu_coulomb=0.4, nk=4))
    b.add_planar_constraint("box", "ground", [0.0, 1.0, 0.0])
    return b


def make_compliant_ball():
    """tests/test_compliant.py's ball (1 kg, radius 0.5, kp=5000, kv=100,
    stabilization off), started just touching the plane."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]), compliant=True)
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    b.set_contact_params("ground", "ball", sc.ContactParams(
        penalty_kp=COMPLIANT_KP, penalty_kv=100.0))
    b.stab_max_iters = 0
    return b


MODEL_SCENES = {
    "truecone": lambda: make_stack(nk=0),
    "mixed": make_mixed,
    "compliant": lambda: make_stack(compliant=True),
    "chain": make_chain,
    "gear": make_gear_pendulum,
    "planar": make_planar_box,
}


def models_config(name, device, B, seed, dtype=None):
    """(scene, state of B scenarios) of one configuration of the models
    phases, with numpy-made per-scenario jitter from `seed`: the stacks'
    height jitter of the step phase, a lift of the whole chain (1 mm into
    the plane) and its anchor in [0, 2) mm, the gear pendulum's joint
    rates, the planar box's in-plane speed."""
    scene, st = MODEL_SCENES[name]().compile(device=device, dtype=dtype)
    if name in ("truecone", "mixed", "compliant"):
        return scene, jittered(st, B, seed)
    rng = np.random.default_rng(seed)
    st = st.expand(B)

    def t(x):
        return torch.tensor(x, dtype=st.pos.dtype, device=st.pos.device)

    if name == "chain":
        pos = st.pos.clone()
        pos[:, :-1, 2] += t(rng.uniform(0.0, 2e-3, size=(B, 1)))
        return scene, st.replace(pos=pos)
    if name == "gear":
        return scene, st.replace(qd_art=st.qd_art + t(rng.normal(size=(B, 2)) * 0.2))
    vel = st.vel.clone()
    vel[:, 0, 0] += t(rng.uniform(-0.2, 0.2, size=B))
    return scene, st.replace(vel=vel)


def phase_models(seed):
    """The full-width runs of the other contact models: MODELS_BATCH
    scenarios of each configuration of MODELS_STEPS through `stepper.step`
    on the card, float32. Returns what the kernel checks and the timing
    need, by configuration."""
    out = {}
    for name in MODELS_STEPS:
        out[name] = run_model(name, seed)
    return out


@contextlib.contextmanager
def lcp_recording():
    """While open, what the step hands `ppm_lcp` is recorded by LCP origin
    (the NQP's kappa pre-solves, the QP, the no-slip MLCP, stabilization)
    beside the LCPs as they entered `_solve_accel`, and one NQP problem is
    kept for counting its launches; `ppm_lcp`'s count starts at 0. Yields a
    dict: "recorded", "entered", "nqp_args", and "launches" once closed."""
    from moby_tpu_torch.sim import impact, noslip, nqp, stabilization
    from moby_tpu_torch.solvers import hopper_lcp, lcp

    rec = {"recorded": [], "entered": [], "nqp_args": []}
    origin = {"lcp": "?"}
    saved = (hopper_lcp.ppm_lcp, lcp._solve_accel, nqp._kappa, nqp.solve_nqp,
             impact.resolve_impacts, noslip.solve_noslip, stabilization.stabilize)
    wrapper, accel, kappa, solve_nqp, resolve_qp, solve_ns, stab = saved

    def recording(M, q, mask, z0=None, max_piv=None):
        rec["recorded"].append((origin["lcp"], M, q, mask, z0))
        return wrapper(M, q, mask, z0=z0, max_piv=max_piv)

    def recording_accel(M, q, mask, z0, skip, plain_fallback):
        live = ~lcp._no_skip(skip, q)
        rec["entered"].append((origin["lcp"], M, q, mask & live[:, None], z0))
        return accel(M, q, mask, z0, skip, plain_fallback)

    def keeping_nqp(*a, **kw):
        if not rec["nqp_args"]:
            rec["nqp_args"].append((a, kw))
        return solve_nqp(*a, **kw)

    def tagged(tag, fn):
        def call(*a, **kw):
            outer, origin["lcp"] = origin["lcp"], tag
            out = fn(*a, **kw)
            origin["lcp"] = outer
            return out
        return call

    hopper_lcp.ppm_lcp = recording
    lcp._solve_accel = recording_accel
    nqp._kappa = tagged("kappa", kappa)
    nqp.solve_nqp = keeping_nqp
    impact.resolve_impacts = tagged("qp", resolve_qp)
    noslip.solve_noslip = tagged("noslip", solve_ns)
    stabilization.stabilize = tagged("stabilization", stab)
    recording.launches = 0
    hopper_lcp.bpp_lcp.launches = 0
    try:
        yield rec
    finally:
        (hopper_lcp.ppm_lcp, lcp._solve_accel, nqp._kappa, nqp.solve_nqp,
         impact.resolve_impacts, noslip.solve_noslip, stabilization.stabilize) = saved
    rec["launches"] = recording.launches
    assert hopper_lcp.bpp_lcp.launches == 0    # the step's cascade has no bpp_lcp stage
    assert len(rec["recorded"]) == rec["launches"]


def recorded_run(scene, st, n_steps, dt, on_step=None):
    """`n_steps` steps of `stepper.step` on the card after a warm-up step,
    with what the step hands `ppm_lcp` recorded (`lcp_recording`).
    `on_step(st)` runs after each step. Returns (state, seconds,
    scenario-steps with an impact solve, recorded, entered, nqp_args,
    launches)."""
    from moby_tpu_torch.sim import stepper

    stepper.step(scene, st, dt, device=DEVICE)        # warm-up, not counted
    torch.cuda.synchronize()
    solved = torch.zeros((), dtype=torch.int64, device=DEVICE)
    t0 = time.time()
    with lcp_recording() as rec:
        for _ in range(n_steps):
            st = stepper.step(scene, st, dt, device=DEVICE)
            solved += (st.solver_pivots > 0).sum()
            if on_step is not None:
                on_step(st)
        torch.cuda.synchronize()
    elapsed = time.time() - t0
    return (st, elapsed, int(solved), rec["recorded"], rec["entered"],
            rec["nqp_args"], rec["launches"])


def kernel_work(recorded):
    """(calls with work, problems with work by LCP origin) of recorded
    `ppm_lcp` calls."""
    with_work = {}
    for (who, _, _, m, _) in recorded:
        with_work[who] = with_work.get(who, 0) + int(m.any(dim=1).sum())
    return sum(int(bool(m.any())) for (_, _, _, m, _) in recorded), with_work


def run_model(name, seed):
    from moby_tpu_torch.sim import bilateral, kinematics, nqp, stepper

    B, n_steps = MODELS_BATCH, MODELS_STEPS[name]
    scene, st = models_config(name, DEVICE, B, seed, torch.float32)
    vio = torch.zeros((), dtype=torch.float32, device=DEVICE)

    def violation(st):
        nonlocal vio
        if scene.bilaterals:
            _, C = bilateral.constraint_rows(scene, st, kinematics.compute(scene, st))
            vio = torch.maximum(vio, C.abs().max())

    st, elapsed, solved, recorded, entered, nqp_args, launches = recorded_run(
        scene, st, n_steps, MODELS_DT, violation)

    for f in ("pos", "quat", "vel", "omega", "q_art", "qd_art"):
        assert torch.isfinite(getattr(st, f)).all(), f"models {name}: {f} not finite"
    z = st.pos[..., 2]
    if name in ("truecone", "mixed", "compliant"):
        zs = z[:, :3]
        gaps = zs[:, 1:] - zs[:, :-1]
        lowest = float((zs[:, 0] - z[:, 3] - 1.0).min())
        # the compliant stack's springs give way: 3·mg/kp = 5.9 mm at the
        # bottom at rest, more while the landing spheres bounce
        sink = 2.5e-2 if name == "compliant" else 5e-3
        assert lowest > -sink and float(gaps.min()) > 2.0 - sink, (
            f"models {name}: the stack sank (lowest {lowest:.3e}, gap {float(gaps.min()):.3e})")
        detail = f"lowest sphere bottom {lowest:+.3e} m, min gap {float(gaps.min()) - 2.0:+.3e} m"
    else:
        detail = f"max bilateral |C| over the run {float(vio):.3e}"
        assert float(vio) < BILATERAL_VIO_LIMIT, f"models {name}: |C| = {float(vio):.3e}"
    calls_with_work, with_work = kernel_work(recorded)
    rate = B * n_steps / elapsed
    log(f"[models] {name}: B={B} steps={n_steps} dt={MODELS_DT} float32, "
        f"K={scene.n_contacts} n_lcp={scene.n_lcp} bilateral rows="
        f"{bilateral.total_rows(scene)}: {elapsed:.2f} s, {rate:.1f} scenario-steps/s; "
        f"scenario-steps with an impact solve {solved} of {B * n_steps}; {detail}")
    log(f"[models] {name}: ppm_lcp launches={launches} ({launches / n_steps:.2f} a step), "
        f"calls with work={calls_with_work}, problems with work by LCP={with_work}")
    if name != "compliant":
        assert solved > 0, f"models {name}: no impact was ever solved"
    # the device's busy share of one step (the profiler records kernels
    # only: these steps issue up to 150,000 launches)
    k, us = launches_of(lambda: stepper.step(scene, st, MODELS_DT, device=DEVICE))
    log(f"[models] {name}: device busy {us / 1e3:.2f} ms of a "
        f"{elapsed / n_steps * 1e3:.2f} ms step (idle share "
        f"{1.0 - us / 1e6 / (elapsed / n_steps):.3f}), {k} kernel launches a step")
    nqp_launches = None
    if nqp_args and name == "truecone":
        a, kw = nqp_args[0]
        nqp_launches, us = launches_of(lambda: nqp.solve_nqp(*a, **kw))
        log(f"[models] {name}: one NQP solve (B={B}, n={3 * scene.n_contacts + scene.n_limits}, "
            f"{nqp.POWER_ITERS} + {nqp.OUTER_ITERS}x{nqp.INNER_ITERS} fixed iterations) "
            f"takes {nqp_launches} kernel launches and {us / 1e3:.3f} ms of device time")
    return {"launches": launches, "recorded": recorded, "entered": entered,
            "rate": rate, "calls_with_work": calls_with_work, "steps": n_steps,
            "problems_with_work": with_work, "nqp_launches": nqp_launches,
            "launches_a_step": k, "idle_share": 1.0 - us / 1e6 / (elapsed / n_steps)}


def phase_kernels_models(models, qp_nv=None, verify=True):
    """`ppm_lcp` against `ppm_lcp_plain` on the LCPs the models' (or the
    geometry's) paths recorded — the NQP's kappa pre-solves, the mixed
    scene's QP islands and no-slip MLCPs, the chain's QP over the projected
    inverse inertia, the curved and convex contacts' QPs, and
    stabilization — float32 as recorded and float64: the calls as the
    cascade handed them to the kernel and the LCPs as they entered
    `_solve_accel` (cold), by the velocity change M·z; the same LCPs made
    strictly monotone (+0.05·I on the active block) by z. `qp_nv` maps a
    configuration to its QP's variable count: its QP-KKT LCPs are then held
    by the QP's velocity change H·x (`check_qp_velocity_case`), since the
    curved solids' and polyhedra's coplanar contacts make H singular and the
    multiplier rows of M·z not unique. `verify` goes to both checks of the
    LCPs as recorded (`both_versions`). Returns the largest z error."""
    from moby_tpu_torch.solvers import hopper_lcp

    worst = 0.0
    for name, run in models.items():
        whos = sorted({r[0] for r in run["entered"]})
        for who in whos:
            handed = [r for r in run["recorded"] if r[0] == who and bool(r[3].any())][:2]
            full = [r for r in run["entered"] if r[0] == who and bool(r[3].any())][:2]
            n = run["recorded"][0][1].shape[1] if not full else full[0][1].shape[1]
            # float64 where the size gate lets the kernel take it (n <= 96)
            for dtype in [d for d in (torch.float32, torch.float64)
                          if hopper_lcp.fits(n, d)]:
                def cast(t):
                    return None if t is None else t.to(dtype).contiguous()

                nv = (qp_nv or {}).get(name) if who == "qp" else None

                def check(label, M, q, mask, z0):
                    if nv is None:
                        check_velocity_case(label, M, q, mask, z0, verify)
                    else:
                        check_qp_velocity_case(label, M, q, mask, z0, nv, solver="ppm",
                                               verify=verify)

                for (_, M, q, mask, z0) in handed:
                    check(f"{name} {who} as handed", cast(M), cast(q),
                          mask.contiguous(), cast(z0))
                for (_, M, q, mask, _) in full:
                    M, q, mask = cast(M), cast(q), mask.contiguous()
                    check(f"{name} {who} LCPs cold", M, q, mask, None)
                    Mr = (M + 0.05 * torch.diag_embed(mask.to(dtype))).contiguous()
                    e, _, _ = check_case(f"{name} {who} LCPs + 0.05 I cold", Mr, q,
                                         mask, None)
                    worst = max(worst, e)
    return worst


def measure_models_kernel(models, label="the models'"):
    """`ppm_lcp` on the models' (or the geometry's) paths: launches a step by
    configuration and the kernel timed on up to two calls with work of each
    LCP origin."""
    picks = []
    for name, run in models.items():
        for who in sorted({r[0] for r in run["recorded"]}):
            picks += [(f"{name} {who}",) + r[1:] for r in run["recorded"]
                      if r[0] == who and bool(r[3].any())][:2]
    out = {
        "launches_per_step": {k: r["launches"] / r["steps"] for k, r in models.items()},
        "calls_with_work": {k: r["calls_with_work"] for k, r in models.items()},
        "scenario_steps_per_s": {k: r["rate"] for k, r in models.items()},
        "nqp_solve_launches": {k: r["nqp_launches"] for k, r in models.items()
                               if r["nqp_launches"] is not None},
    }
    if picks:
        out["timed_on"] = time_ppm_calls(
            picks, f"{len(picks)} of {label} calls with work ({sorted({p[0] for p in picks})})")
    return out


def parity_run(name, device, seed, dtype=None):
    """(positions (steps, B, nb, 3), q_art (steps, B, nq), max |C| over the
    run) of one configuration at MODELS_PARITY_BATCH on `device` (float32
    on the card, float64 on the CPU)."""
    from moby_tpu_torch.sim import bilateral, kinematics, stepper

    scene, st = models_config(name, device, MODELS_PARITY_BATCH, seed, dtype)
    pos, qa = [], []
    vio = st.pos.new_zeros(())
    for _ in range(MODELS_PARITY_STEPS[name]):
        st = stepper.step(scene, st, MODELS_DT, device=device)
        pos.append(st.pos)
        qa.append(st.q_art)
        if scene.bilaterals:
            _, C = bilateral.constraint_rows(scene, st, kinematics.compute(scene, st))
            vio = torch.maximum(vio, C.abs().max())
    return (torch.stack(pos).double().cpu(), torch.stack(qa).double().cpu(),
            float(vio))


def phase_models_parity(seed):
    """Card float32 against the port on the CPU in float64 (plain cascade)
    for every configuration of MODEL_SCENES: the largest drift of the
    positions and joint coordinates over the run, held to
    MODELS_DRIFT_LIMIT; the bilateral violation on the card held to
    BILATERAL_VIO_LIMIT; then the compliant ball settles at its spring
    compression."""
    from moby_tpu_torch.sim import stepper

    drifts = {}
    for name in MODEL_SCENES:
        t0 = time.time()
        pc, qc, vio = parity_run(name, DEVICE, seed + 1)
        t1 = time.time()
        pr, qr, vio_cpu = parity_run(name, "cpu", seed + 1)
        drift = float(torch.cat([(pc - pr).flatten(), (qc - qr).flatten(),
                                 torch.zeros(1, dtype=pc.dtype)]).abs().max())
        drifts[name] = drift
        log(f"[modelsparity] {name}: B={MODELS_PARITY_BATCH} steps="
            f"{MODELS_PARITY_STEPS[name]}: max position drift {drift:.3e} (limit "
            f"{MODELS_DRIFT_LIMIT[name]:.1e}), bilateral |C| card {vio:.3e} CPU "
            f"{vio_cpu:.3e}; card {t1 - t0:.1f} s, CPU {time.time() - t1:.1f} s")
        assert torch.isfinite(pc).all(), f"modelsparity {name}: not finite"
        assert drift < MODELS_DRIFT_LIMIT[name], f"modelsparity {name}: drift {drift:.3e}"
        assert vio < BILATERAL_VIO_LIMIT, f"modelsparity {name}: |C| {vio:.3e}"

    # a reading, not a check: with a joint given twice the Gram matrix
    # J·iM·Jᵀ is singular, and its fixed shift of 1e-12 is below float32
    # rounding (the CPU float64 run stays finite)
    from moby_tpu_torch.sim import bilateral, kinematics

    b = make_chain(n=2)
    b.add_point_constraint("c0", [0.2, 0.0, 0.0], "c1", [-0.2, 0.0, 0.0])
    scene, st = b.compile(device=DEVICE)
    st = st.expand(MODELS_PARITY_BATCH)
    for _ in range(5):
        st = stepper.step(scene, st, MODELS_DT, device=DEVICE)
    _, C = bilateral.constraint_rows(scene, st, kinematics.compute(scene, st))
    log(f"[modelsparity] a point joint given twice, float32 on the card, 5 steps: "
        f"positions finite {bool(torch.isfinite(st.pos).all())}, max |C| "
        f"{float(C.abs().max()):.3e}")

    scene, st = make_compliant_ball().compile(device=DEVICE)
    st = st.expand(MODELS_PARITY_BATCH)
    for _ in range(COMPLIANT_SETTLE_STEPS):
        st = stepper.step(scene, st, MODELS_DT, device=DEVICE)
    depth = 0.5 - st.pos[:, 0, 2].double()
    expect = 9.81 / COMPLIANT_KP
    rel = float(((depth - expect) / expect).abs().max())
    log(f"[modelsparity] compliant ball after {COMPLIANT_SETTLE_STEPS} steps: "
        f"compression {float(depth.min()):.4e}-{float(depth.max()):.4e} m against "
        f"mg/kp = {expect:.4e} m ({rel:.3f} off), |vz| "
        f"{float(st.vel[:, 0, 2].abs().max()):.2e} m/s")
    assert rel < COMPLIANT_SETTLE_RTOL, f"modelsparity: the compliant ball is {rel:.3f} off"
    return drifts


# ---------------------------------------------------------------- geometry
S2 = float(np.sqrt(0.5))
Q_Y_TO_X = np.array([0.0, 0.0, -S2, S2])    # local Y -> world x
Q_Y_TO_Z = np.array([S2, 0.0, 0.0, S2])     # local Y -> world z
OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                 [0, 0, -1.0]])


def cube_verts(h):
    return np.array([[sx * h, sy * h, sz * h] for sx in (-1, 1)
                     for sy in (-1, 1) for sz in (-1, 1)], np.float64)


def make_curved():
    """Bodies of GEOM_MASS: a cylinder (r=0.5, h=1) on its side spinning at
    2 rad/s about its
    axis, a cone (r=0.6, h=1.2) base down and a torus (R=1, r=0.25) lying
    flat, on one plane (mu=0.5, nk=4; kinds 4, 10 and 5); the pairs between
    the curved bodies are support pairs, of a later slice, and disabled."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    m = GEOM_MASS
    cone_i = m * np.diag([0.1 * 1.44 + 0.15 * 0.36, 0.36 / 3.0, 0.1 * 1.44 + 0.15 * 0.36])
    torus_i = m * np.diag([0.5 + 0.625 * 0.0625, 0.5 + 0.625 * 0.0625, 1.0 + 0.75 * 0.0625])
    b.add_body("cyl", mass=m, inertia=sc.cylinder_inertia(m, 0.5, 1.0),
               pos=np.array([0.0, 0.0, 0.5]), quat=Q_Y_TO_X,
               ang_vel=np.array([2.0, 0.0, 0.0]))
    b.add_geom("cyl", sc.CYLINDER, [0.5, 1.0])
    b.add_body("cone", mass=m, inertia=cone_i, pos=np.array([3.0, 0.0, 0.6]),
               quat=Q_Y_TO_Z)
    b.add_geom("cone", sc.CONE, [0.6, 1.2])
    b.add_body("torus", mass=m, inertia=torus_i, pos=np.array([-3.5, 0.0, 0.25]))
    b.add_geom("torus", sc.TORUS, [1.0, 0.25])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    names = ("cyl", "cone", "torus")
    for i, n in enumerate(names):
        b.set_contact_params("ground", n, cp)
        for m in names[i + 1:]:
            b.disabled_pairs.add(tuple(sorted((n, m))))
    return b


def make_octastack():
    """Two octahedra (POLYHEDRON, 0.5 m to their tips, GEOM_MASS each) stacked face down on
    the plane (tests/test_convex_manifold.py:142; mu=0.5): kind 3 for the
    plane, kind 9 between them. K = 6 + 6 + 8 slots, an LCP of n = 160, the
    largest `ppm_lcp` takes in float32."""
    from moby_tpu_torch.core import scene as sc

    n = np.ones(3) / np.sqrt(3.0)
    axis = np.cross(n, [0.0, 0.0, -1.0])
    axis /= np.linalg.norm(axis)
    ang = np.arccos(-n[2])
    q_fd = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])
    r_in = 0.5 / np.sqrt(3.0)
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    for name, z in (("o1", r_in), ("o2", 3 * r_in)):
        b.add_body(name, mass=GEOM_MASS, inertia=np.eye(3) * 0.05 * GEOM_MASS,
                   pos=np.array([0.0, 0.0, z]), quat=q_fd)
        b.add_geom(name, sc.POLYHEDRON, [0.0], verts=OCTA * 0.5)
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    b.set_contact_params("ground", "o1", cp)
    b.set_contact_params("o1", "o2", cp)
    return b


def make_platforms():
    """Bodies of GEOM_MASS: an octahedron (0.4 m to its tips) tip down on a fixed BOX platform
    (tests/test_gjk.py:68; mu=0: at rest its centre is 0.65 m up; kind 9,
    POLYHEDRON-BOX) and, 10 m away, a polyhedral cube on a fixed polyhedral
    slab (tests/test_convex_manifold.py:44-73; mu=0.5; kind 9,
    POLYHEDRON-POLYHEDRON); no ground, their mutual pairs disabled. K = 16,
    n = 128."""
    from moby_tpu_torch.core import scene as sc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("octa", mass=GEOM_MASS, inertia=np.eye(3) * 0.05 * GEOM_MASS,
               pos=np.array([0.0, 0.0, OCTA_REST_Z]))
    b.add_geom("octa", sc.POLYHEDRON, [0.0], verts=OCTA * 0.4)
    b.add_body("plat", enabled=False)
    b.add_geom("plat", sc.BOX, [2.0, 2.0, 0.25])
    b.add_body("cube", mass=GEOM_MASS,
               inertia=sc.box_inertia(GEOM_MASS, 0.5, 0.5, 0.5),
               pos=np.array([10.0, 0.0, 1.5]))
    b.add_geom("cube", sc.POLYHEDRON, [0.0], verts=cube_verts(0.5))
    b.add_body("slab", enabled=False, pos=np.array([10.0, 0.0, 0.0]))
    b.add_geom("slab", sc.POLYHEDRON, [0.0],
               verts=cube_verts(1.0) * np.array([4.0, 4.0, 1.0]))
    b.set_contact_params(
        "octa", "plat", sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=4))
    b.set_contact_params("cube", "slab", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5))
    for x in ("octa", "plat"):
        for y in ("cube", "slab"):
            b.disabled_pairs.add(tuple(sorted((x, y))))
    return b


# the convex polyhedra of the slice in two scenes: one impact LCP covers a
# scene, and the three kind-9 pairs in one would make it n = 8·K >= 192,
# past what `ppm_lcp` takes (n <= 160 in float32, `hopper_lcp.fits`)
GEOMETRY_SCENES = {"curved": make_curved, "octastack": make_octastack,
                   "platforms": make_platforms}


def geometry_config(name, device, B, seed, dtype=None):
    """(scene, state of B scenarios) of a geometry configuration: every
    enabled body lifted by numpy-made jitter in [0, GEOM_LIFT) from `seed`
    (the second octahedron of the stack by its own and the first's) and
    moving down at GEOM_DROP."""
    scene, st = GEOMETRY_SCENES[name]().compile(device=device, dtype=dtype)
    nb = st.pos.shape[1]
    en = scene.host["enabled"][None, :]
    dz = np.random.default_rng(seed).uniform(0.0, GEOM_LIFT, size=(B, nb)) * en
    if name == "octastack":
        dz[:, 2] += dz[:, 1]           # o2 rests on o1
    st = st.expand(B)
    pos, vel = st.pos.clone(), st.vel.clone()
    pos[:, :, 2] += torch.tensor(dz, dtype=pos.dtype, device=pos.device)
    vel[:, :, 2] -= torch.tensor(GEOM_DROP * en, dtype=vel.dtype, device=vel.device)
    return scene, st.replace(pos=pos, vel=vel)


def run_geometry(name, seed):
    """GEOM_BATCH scenarios of one geometry configuration through
    `stepper.step` on the card, float32 (`run_config`)."""
    from moby_tpu_torch.solvers import hopper_lcp

    scene, st = geometry_config(name, DEVICE, GEOM_BATCH, seed, torch.float32)
    rest = {"curved": [0.0, 0.5, 0.6, 0.25],
            "octastack": [0.0, 0.5 / np.sqrt(3.0), 1.5 / np.sqrt(3.0)],
            "platforms": [OCTA_REST_Z, 0.0, 1.5, 0.0]}[name]
    out = run_config("geometry", name, scene, st, GEOM_STEPS[name], rest)
    if name != "curved":
        assert scene.n_lcp <= 160 and hopper_lcp.fits(scene.n_lcp, torch.float32)
    return out


def run_config(tag, name, scene, st, n_steps, rest, detail=""):
    """`n_steps` steps of GEOM_BATCH scenarios of a configuration on the card
    (`recorded_run`), every body at least `rest` (its centre height at rest,
    by body) less 5 mm at the end: scenario-steps/s, the device's busy share
    and launches of a step, the launches and device time of one
    `narrow_phase` call, `ppm_lcp`'s launches and calls with work."""
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import kinematics, stepper

    B = st.pos.shape[0]
    kinds = sorted({k for k, _ in scene.kind_groups})
    st, elapsed, solved, recorded, entered, _, launches = recorded_run(
        scene, st, n_steps, GEOM_DT)
    for f in ("pos", "quat", "vel", "omega"):
        assert torch.isfinite(getattr(st, f)).all(), f"{tag} {name}: {f} not finite"
    assert solved > 0, f"{tag} {name}: no impact was ever solved"
    z = st.pos[..., 2].double().cpu().numpy()
    low = (z - np.array(rest)).min(axis=0)
    sank = (f"lowest centre of each body against its rest height "
            f"{low.round(6).tolist()} m")
    assert low.min() > -5e-3, f"{tag} {name}: a body sank ({sank})"
    calls_with_work, with_work = kernel_work(recorded)
    rate = B * n_steps / elapsed
    log(f"[{tag}] {name}: kinds {kinds}, B={B} steps={n_steps} dt={GEOM_DT} "
        f"float32, K={scene.n_contacts} n_lcp={scene.n_lcp}{detail}: {elapsed:.2f} s, "
        f"{rate:.1f} scenario-steps/s; scenario-steps with an impact solve "
        f"{solved} of {B * n_steps}; {sank}")
    log(f"[{tag}] {name}: ppm_lcp launches={launches} ({launches / n_steps:.2f} a "
        f"step), calls with work={calls_with_work}, problems with work by LCP={with_work}")
    k, us = launches_of(lambda: stepper.step(scene, st, GEOM_DT, device=DEVICE))
    pt = kinematics.compute(scene, st)
    knp, usnp = launches_of(lambda: nph.narrow_phase(scene, pt.pos, pt.quat, 1e-3))
    log(f"[{tag}] {name}: device busy {us / 1e3:.2f} ms of a "
        f"{elapsed / n_steps * 1e3:.2f} ms step (idle share "
        f"{1.0 - us / 1e6 / (elapsed / n_steps):.3f}), {k} kernel launches a step; "
        f"one narrow_phase call {knp} launches, {usnp / 1e3:.3f} ms of device time")
    return {"launches": launches, "recorded": recorded, "entered": entered,
            "rate": rate, "calls_with_work": calls_with_work, "steps": n_steps,
            "problems_with_work": with_work, "nqp_launches": None,
            "n_vars": scene.n_vars, "launches_a_step": k,
            "narrow_phase_launches": knp,
            "idle_share": 1.0 - us / 1e6 / (elapsed / n_steps), "state": st}


def phase_geometry(seed):
    """The curved solids on a plane and the convex polyhedra at full width."""
    return {name: run_geometry(name, seed) for name in GEOMETRY_SCENES}


def geometry_parity_run(name, device, seed, dtype=None):
    """Positions (steps, B, nb, 3) of a geometry configuration at
    GEOM_PARITY_BATCH on `device` (float32 on the card, float64 on the
    CPU unless `dtype` says otherwise)."""
    from moby_tpu_torch.sim import stepper

    scene, st = geometry_config(name, device, GEOM_PARITY_BATCH, seed, dtype)
    pos = []
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)       # B=4: more threads only synchronise
    try:
        for _ in range(GEOM_PARITY_STEPS[name]):
            st = stepper.step(scene, st, GEOM_DT, device=device)
            pos.append(st.pos)
    finally:
        torch.set_num_threads(threads)
    return torch.stack(pos).double().cpu()


_OCTA_OBJ = """# an octahedron, outward faces
v 0.3 0 0
v -0.3 0 0
v 0 0.3 0
v 0 -0.3 0
v 0 0 0.3
v 0 0 -0.3
f 1 3 5
f 3 2 5
f 2 4 5
f 4 1 5
f 3 1 6
f 2 3 6
f 4 2 6
f 1 4 6
"""

_SHAPES_XML = """<XML>
<DRIVER step-size="0.001" />
<MOBY>
  <Cylinder id="cyl" radius="0.5" height="1" density="2.0" />
  <Cone id="cone" radius="0.6" height="1.2" mass="1.5" />
  <Torus id="tor" major-radius="1.0" minor-radius="0.25" density="0.5" />
  <Polyhedron id="oct" filename="octa.obj" mass="0.8" />
  <Plane id="p" />
  <GravityForce id="g" accel="0 0 -9.81" />
  <RigidBody id="can" position="0 0 0.5002" rpy="0 0 1.5707963267949">
    <InertiaFromPrimitive primitive-id="cyl" /><CollisionGeometry primitive-id="cyl" />
  </RigidBody>
  <RigidBody id="cone" position="3 0 0.6002" rpy="1.5707963267949 0 0">
    <InertiaFromPrimitive primitive-id="cone" /><CollisionGeometry primitive-id="cone" />
  </RigidBody>
  <RigidBody id="torus" position="-3.5 0 0.2502">
    <InertiaFromPrimitive primitive-id="tor" /><CollisionGeometry primitive-id="tor" />
  </RigidBody>
  <RigidBody id="poly" position="0 4 0.3002" rpy="0 0 0.3">
    <InertiaFromPrimitive primitive-id="oct" /><CollisionGeometry primitive-id="oct" />
  </RigidBody>
  <RigidBody id="ground" enabled="false"><CollisionGeometry primitive-id="p" /></RigidBody>
  <TimeSteppingSimulator>
    <DynamicBody dynamic-body-id="can" /><DynamicBody dynamic-body-id="cone" />
    <DynamicBody dynamic-body-id="torus" /><DynamicBody dynamic-body-id="poly" />
    <DynamicBody dynamic-body-id="ground" />
    <RecurrentForce recurrent-force-id="g" />
    <ContactParameters object1-id="ground" object2-id="can" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="poly" mu-coulomb="0.5" epsilon="0" />
{disabled}
  </TimeSteppingSimulator>
</MOBY></XML>"""


def write_shapes_scene(directory):
    """A Moby XML scene of this slice's primitive tags, its <Polyhedron>'s
    OBJ beside it: a cylinder on its side, a cone base down, a torus flat
    and an octahedron tip down, each 0.2 mm above one plane; the pairs
    between them (support pairs) disabled. Returns the scene's path."""
    names = ("can", "cone", "torus", "poly")
    disabled = "\n".join(f'    <DisabledPair object1-id="{a}" object2-id="{b}" />'
                         for i, a in enumerate(names) for b in names[i + 1:])
    with open(os.path.join(directory, "octa.obj"), "w") as f:
        f.write(_OCTA_OBJ)
    path = os.path.join(directory, "shapes.xml")
    with open(path, "w") as f:
        f.write(_SHAPES_XML.format(disabled=disabled))
    return path


def phase_geometry_parity(seed):
    """Card float32 against the port on the CPU in float64 for both geometry
    configurations at GEOM_PARITY_BATCH: the largest position drift within
    GEOM_DRIFT_LIMIT; on the card the spinning cylinder's axis stays above
    r - 1e-3 and the octahedron comes to rest on the platform within 1e-3
    of 0.65 m. Then the regress CLI on an XML scene of the four primitive
    tags written into a temporary directory, GEOM_REGRESS_STEPS steps on the
    card and with --cpu, compared within REGRESS_TOL."""
    drifts = {}
    for name in GEOMETRY_SCENES:
        t0 = time.time()
        pc = geometry_parity_run(name, DEVICE, seed + 1)
        t1 = time.time()
        pr = geometry_parity_run(name, "cpu", seed + 1)
        drift = float((pc - pr).abs().max())
        drifts[name] = drift
        assert torch.isfinite(pc).all(), f"geometryparity {name}: not finite"
        held = []
        if name == "octastack":
            detail = f"octahedra at {pc[-1, :, 1:, 2].mean(dim=0).tolist()} m"
        elif name == "curved":
            zc = float(pc[:, :, 1, 2].min())
            travel = float((pc[-1, :, 1, 1] - pc[0, :, 1, 1]).abs().max())
            detail = (f"cylinder axis lowest {zc:.6f} m (limit {CYL_MIN_Z}), rolled "
                      f"{travel * 1e3:.3f} mm along y")
            held.append((zc > CYL_MIN_Z, f"the cylinder sank to {zc:.6f}"))
        else:
            # the test holds the height in float64; float32 stabilization
            # parks a resting body up to 2·NEAR_ZERO above its support and
            # lets it fall back (ROADMAP §3), which the card may read at the
            # last step
            off_cpu = float((pr[-1, :, 0, 2] - OCTA_REST_Z).abs().max())
            off = float((pc[-1, :, 0, 2] - OCTA_REST_Z).abs().max())
            park = 2.0 * NEAR_ZERO_F32
            detail = (f"octahedron on the platform {off_cpu:.2e} off {OCTA_REST_Z} m in "
                      f"CPU float64 (limit {OCTA_REST_TOL}), {off:.2e} on the card "
                      f"(limit {OCTA_REST_TOL} + 2·NEAR_ZERO = {OCTA_REST_TOL + park:.2e})")
            held.append((off_cpu < OCTA_REST_TOL, f"octahedron {off_cpu:.3e} off its rest"))
            held.append((off < OCTA_REST_TOL + park, f"octahedron {off:.3e} off on the card"))
        log(f"[geometryparity] {name}: B={GEOM_PARITY_BATCH} steps="
            f"{GEOM_PARITY_STEPS[name]}: max position drift {drift:.3e} (limit "
            f"{GEOM_DRIFT_LIMIT[name]:.1e}); {detail}; card {t1 - t0:.1f} s, CPU "
            f"{time.time() - t1:.1f} s")
        for ok, what in held:
            assert ok, f"geometryparity {name}: {what}"
        assert drift < GEOM_DRIFT_LIMIT[name], f"geometryparity {name}: drift {drift:.3e}"

    regress_card_against_cpu("geometryparity", write_shapes_scene,
                             "the shapes scene (Cylinder, Cone, Torus, Polyhedron from an OBJ)")
    return drifts


def regress_card_against_cpu(tag, write_scene, label):
    """The regress CLI on the scene `write_scene(directory)` writes into a
    temporary directory, GEOM_REGRESS_STEPS steps on the card and with
    --cpu, compared by `compare` within REGRESS_TOL."""
    import tempfile

    from moby_tpu_torch.cli import compare, regress

    with tempfile.TemporaryDirectory() as tmp:
        path = write_scene(tmp)
        dumps, secs = {}, {}
        for mode in ("card", "cpu"):
            dumps[mode] = os.path.join(tmp, f"scene.{mode}.dat")
            argv = [f"-s={GEOM_DT}", f"-mi={GEOM_REGRESS_STEPS}", path, dumps[mode]]
            t0 = time.time()
            assert regress.main(argv + (["--cpu"] if mode == "cpu" else [])) == 0
            secs[mode] = time.time() - t0
        err, where, n = compare.compare(dumps["cpu"], dumps["card"])
        log(f"[{tag}] regress of {label}: {n} lines, card float32 against --cpu float64 "
            f"L-inf {err:.3e} (worst at line, column {where}; limit {REGRESS_TOL:.0e}); "
            f"card {secs['card']:.1f} s, CPU {secs['cpu']:.1f} s")
        assert n == GEOM_REGRESS_STEPS, f"{tag} regress: {n} lines"
        assert compare.main([dumps["cpu"], dumps["card"], str(REGRESS_TOL)]) == 0, (
            f"{tag} regress: {err:.3e}")


# ----------------------------------------------------------- triangle meshes
# the JAX package's mesh tests' polygons (tests/test_trimesh.py:128-162):
# the non-convex L and the V-notch channel, in the xz plane
L_POLY = [(0, 0), (2, 0), (2, 1), (1, 1), (1, 2), (0, 2)]
NOTCH_POLY = [(0.0, -0.3), (1.0, 0.5), (1.0, -0.8), (-1.0, -0.8), (-1.0, 0.5)]
# local y -> world z (the extruded slab's thickness axis up)
Q_Y_UP = np.array([S2, 0.0, 0.0, S2])


def cube_mesh(h):
    """tests/test_trimesh.py:22: a cube of half-size h as 12 outward triangles."""
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float64)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
                 np.int32)
    return v, f


def icosphere(subdiv, r):
    """tests/test_trimesh_scale.py:15-48: a subdivided icosahedron of
    20·4^subdiv faces, its icosahedron's hull from the port's
    `geometry.hull`."""
    from moby_tpu_torch.geometry import hull

    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            v += [(0, s1, s2 * phi), (s1, s2 * phi, 0), (s2 * phi, 0, s1)]
    v = np.array(v, float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    verts, faces = hull.convex_hull(v)
    for _ in range(subdiv):
        edge_mid, new_faces, vlist = {}, [], list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = vlist[i] + vlist[j]
                edge_mid[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts, faces = np.array(vlist), np.array(new_faces, np.int32)
    return verts * r, faces


def _port_scene():
    from moby_tpu_torch.core import scene

    return scene


def _mesh_body(b, sc, name, verts, faces, pos, quat=None):
    """A dynamic mesh body of GEOM_MASS, its inertia from the mesh."""
    from moby_tpu_torch.geometry import trimesh

    J = trimesh.mesh_inertia(GEOM_MASS, verts, faces)[0]
    b.add_body(name, mass=GEOM_MASS, inertia=J, pos=np.asarray(pos, float), quat=quat)
    b.add_geom(name, sc.TRIMESH, [0.0], verts=verts, faces=faces)


def _apart(b, islands):
    for i, a in enumerate(islands):
        for c in islands[i + 1:]:
            for x in a:
                for y in c:
                    b.disabled_pairs.add(tuple(sorted((x, y))))


def make_meshes(sc=None):
    """The L-prism of tests/test_trimesh.py:128-136 (extrude_polygon,
    non-convex) on the plane (kind 3), and 10 m away a sphere (r=0.3) in
    the V-notch channel of tests/test_trimesh.py:152-162 (kind 11, two
    faces at once); the pairs between the two islands disabled. K = 12 + 4,
    n = 128."""
    sc = sc or _port_scene()
    from moby_tpu_torch.geometry import trimesh

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    lv, lf = trimesh.extrude_polygon(L_POLY, -0.5, 0.5, apex=0)
    com = trimesh.mesh_inertia(GEOM_MASS, lv, lf)[1]
    _mesh_body(b, sc, "L", lv - com, lf, [0.0, 0.0, com[2]])
    nv, nf = trimesh.extrude_polygon(NOTCH_POLY, -1.0, 1.0, apex=0)
    b.add_body("channel", enabled=False, pos=np.array([10.0, 0.0, 0.0]))
    b.add_geom("channel", sc.TRIMESH, [0.0], verts=nv, faces=nf)
    b.add_body("ball", mass=GEOM_MASS, inertia=sc.sphere_inertia(GEOM_MASS, 0.3),
               pos=np.array([10.0, 0.0, 0.3 * np.sqrt(1.64) - 0.3]))
    b.add_geom("ball", sc.SPHERE, [0.3])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    b.set_contact_params("ground", "L", cp)
    b.set_contact_params("channel", "ball", cp)
    _apart(b, [["ground", "L"], ["channel", "ball"]])
    return b


def make_meshstack(sc=None):
    """Two mesh cubes (cube_mesh(0.4), tests/test_trimesh.py:193) stacked on
    the plane (kinds 3 and 13). The upper cube's pair with the plane, 0.8 m
    apart through the run, is disabled: its 8 slots would make n = 192,
    past `ppm_lcp`'s float32 gate. K = 8 + 8, n = 128."""
    sc = sc or _port_scene()

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    v, f = cube_mesh(0.4)
    _mesh_body(b, sc, "m1", v, f, [0.0, 0.0, 0.4])
    _mesh_body(b, sc, "m2", v, f, [0.0, 0.0, 1.2])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    b.set_contact_params("ground", "m1", cp)
    b.set_contact_params("m1", "m2", cp)
    b.disabled_pairs.add(("ground", "m2"))
    return b


def make_meshplatforms(sc=None):
    """A mesh cube (cube_mesh(0.4)) on an analytic BOX platform
    (tests/test_trimesh.py:175-191; kind 12). K = 8 + 8 (its vertices and
    the BOX's corners), n = 128."""
    sc = sc or _port_scene()

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("box", enabled=False)
    b.add_geom("box", sc.BOX, [1.0, 1.0, 0.5])
    v, f = cube_mesh(0.4)
    _mesh_body(b, sc, "mesh", v, f, [0.0, 0.0, 0.9])
    b.set_contact_params("box", "mesh", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5))
    return b


def make_meshslabs(sc=None):
    """A mesh cube (cube_mesh(0.3)) on a POLYHEDRON slab
    (tests/test_trimesh.py:214-235; kind 13 through the slab's hull
    triangles), and 10 m away the 320-face icosphere (subdivided twice,
    r=0.4) on the extruded mesh slab of tests/test_trimesh_scale.py:74-98
    (kind 13, F > FACE_CHUNK: the face-tiled loop), its thickness axis
    turned up. K = 8 + 8, n = 128."""
    sc = sc or _port_scene()
    from moby_tpu_torch.geometry import trimesh

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    slab = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-0.2, 0.2)],
                    np.float64)
    b.add_body("pslab", enabled=False)
    b.add_geom("pslab", sc.POLYHEDRON, [0.0], verts=slab)
    v, f = cube_mesh(0.3)
    _mesh_body(b, sc, "cube", v, f, [0.0, 0.0, 0.5])
    sv, sf = trimesh.extrude_polygon(
        np.array([[-2.0, -2.0], [2.0, -2.0], [2.0, 2.0], [-2.0, 2.0]]), -0.25, 0.25)
    b.add_body("mslab", enabled=False, pos=np.array([10.0, 0.0, 0.0]), quat=Q_Y_UP)
    b.add_geom("mslab", sc.TRIMESH, [0.0], verts=sv, faces=sf)
    iv, if_ = icosphere(2, 0.4)
    _mesh_body(b, sc, "ico", iv, if_, [10.0, 0.0, 0.25 + 0.4])
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5)
    b.set_contact_params("pslab", "cube", cp)
    b.set_contact_params("mslab", "ico", cp)
    _apart(b, [["pslab", "cube"], ["mslab", "ico"]])
    return b


def make_bigmesh(sc=None):
    """The 1,280-face icosphere (subdivided three times, r=0.5,
    tests/test_trimesh_scale.py:15-48) on the plane (kind 3): its 642
    vertices are capped at VSLOT_CAP = 16 slots, the deepest by the contact
    slots' top-k, whose ring of vertices about the lowest one ties in depth.
    K = 16, n = 128."""
    sc = sc or _port_scene()

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=plane_quat())
    iv, if_ = icosphere(3, 0.5)
    _mesh_body(b, sc, "ico", iv, if_, [0.0, 0.0, 0.5])
    b.set_contact_params("ground", "ico", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5))
    return b


# four mesh configurations in five scenes: one impact LCP covers
# a scene and `ppm_lcp` takes n <= 160 in float32 (`hopper_lcp.fits`); the
# mesh cube on the BOX platform (K = 16) beside the cube on the polyhedron
# slab (K = 8), or the big icosphere on the plane (K = 16) beside the small
# one on the mesh slab (K = 8), would make n = 192
MESH_SCENES = {"meshes": make_meshes, "meshstack": make_meshstack,
               "meshplatforms": make_meshplatforms, "meshslabs": make_meshslabs,
               "bigmesh": make_bigmesh}
# each body's centre height at rest, by body (the static ones at their place)
MESH_REST_Z = {"meshes": [0.0, 5.0 / 6.0, 0.0, 0.3 * np.sqrt(1.64) - 0.3],
               "meshplatforms": [0.0, 0.9], "meshslabs": [0.0, 0.5, 0.0, 0.65],
               "bigmesh": [0.0, 0.5]}


# steps of each parity run: the stack takes ~0.7 s a step in CPU float64
# and 21-35 s on the card at B=4 in float32 (its LCPs go to the plain
# cascade, MESH_TIMED)
MESH_PARITY_STEPS = {"meshes": 20, "meshstack": 2, "meshplatforms": 20,
                     "meshslabs": 20, "bigmesh": 20}


def mesh_config(name, device, B, seed, dtype=None):
    """(scene, state of B scenarios) of a mesh configuration: every enabled
    body lifted by numpy-made jitter in [0, GEOM_LIFT) from `seed` (the
    stack's upper cube by its own and the lower one's) and moving down at
    GEOM_DROP."""
    scene, st = MESH_SCENES[name]().compile(device=device, dtype=dtype)
    nb = st.pos.shape[1]
    en = scene.host["enabled"][None, :]
    dz = np.random.default_rng(seed).uniform(0.0, GEOM_LIFT, size=(B, nb)) * en
    if name == "meshstack":
        dz[:, 2] += dz[:, 1]
    st = st.expand(B)
    pos, vel = st.pos.clone(), st.vel.clone()
    pos[:, :, 2] += torch.tensor(dz, dtype=pos.dtype, device=pos.device)
    vel[:, :, 2] -= torch.tensor(GEOM_DROP * en, dtype=vel.dtype, device=vel.device)
    return scene, st.replace(pos=pos, vel=vel)


# the configurations the trimesh phase steps at GEOM_BATCH, and their timed
# steps (after one untimed step). On the card (NVIDIA H100 80GB HBM3, 700 W)
# the stack took 19.4 s a step over 8 steps and 165.7 s in a 1-step run
# (199,437-273,465 launches a step): its singular float32 LCPs fall through
# batched BPP and `ppm_lcp` to the plain cascade, one host synchronisation
# per pivot (`scripts/geometry_float32.py meshlcp`), so it runs in
# trimeshparity alone (whose card run records its LCPs for the kernels
# phase). The slabs' time is their first step's, whose impact QPs the plain
# cascade finishes: 8 timed steps took 23.3 s, 4 20.5-25.4 s, 2 23.9 s
MESH_TIMED = ("meshes", "meshplatforms", "meshslabs", "bigmesh")
MESH_STEPS = {"meshes": 8, "meshplatforms": 8, "meshslabs": 8, "bigmesh": 8}
# 5x the largest position drift of the port's CPU float32 run against its
# CPU float64 run of the same configuration, B=4, seed 1, MESH_PARITY_STEPS
# (20 steps, the stack 2; `scripts/geometry_float32.py mesh`): 8.847e-4,
# 7.482e-4, 6.905e-4, 6.931e-4, 6.905e-4
MESH_DRIFT_LIMIT = {"meshes": 4.42e-3, "meshstack": 3.74e-3, "meshplatforms": 3.45e-3,
                    "meshslabs": 3.47e-3, "bigmesh": 3.45e-3}


def run_mesh(name, seed):
    """GEOM_BATCH scenarios of one mesh configuration through `stepper.step`
    on the card, float32 (`run_config`), and the peak device memory of the
    run and of one `narrow_phase` call: the closest-face intermediates are
    the meshes' largest tensors."""
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import kinematics
    from moby_tpu_torch.solvers import hopper_lcp

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()      # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    scene, st = mesh_config(name, DEVICE, GEOM_BATCH, seed, torch.float32)
    assert scene.n_lcp <= 160 and hopper_lcp.fits(scene.n_lcp, torch.float32), (
        f"trimesh {name}: n = {scene.n_lcp} is past ppm_lcp's gate")
    out = run_config("trimesh", name, scene, st, MESH_STEPS[name], MESH_REST_Z[name],
                     f" vmax={scene.vmax} fmax={scene.geom_faces.shape[1]}")
    peak = torch.cuda.max_memory_allocated() - mem0
    pt = kinematics.compute(scene, out["state"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nph.narrow_phase(scene, pt.pos, pt.quat, 1e-3)
    np_peak = torch.cuda.max_memory_allocated() - base
    log(f"[trimesh] {name}: peak device memory {peak / 2 ** 20:.1f} MiB above the "
        f"{mem0 / 2 ** 20:.1f} MiB held before the scene was built (the recorded LCPs "
        f"included); one narrow_phase call {np_peak / 2 ** 20:.1f} MiB above what was "
        f"allocated")
    if name == "bigmesh":
        slots = scene.host["pair_kind"][scene.host["slot_pair"]] == sc.K_PLANE_GENERIC
        assert slots.sum() == sc.VSLOT_CAP
    out["peak_mib"] = peak / 2 ** 20
    return out


def phase_mesh(seed):
    """The triangle-mesh configurations at full width (MESH_TIMED)."""
    return {name: run_mesh(name, seed) for name in MESH_TIMED}


def mesh_parity_run(name, device, seed, dtype=None, record=False):
    """Positions (steps, B, nb, 3) of a mesh configuration at
    GEOM_PARITY_BATCH on `device` (float32 on the card, float64 on the CPU
    unless `dtype` says otherwise), the most active slots any plane pair
    had after a step, and (with `record`, on the card) what the steps handed
    `ppm_lcp` (`lcp_recording`), else None."""
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.geometry import narrowphase as nph
    from moby_tpu_torch.sim import kinematics, stepper

    scene, st = mesh_config(name, device, GEOM_PARITY_BATCH, seed, dtype)
    plane_slots = torch.as_tensor(
        scene.host["pair_kind"][scene.host["slot_pair"]] == sc.K_PLANE_GENERIC,
        device=st.pos.device)
    pos, most = [], 0
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)       # B=4: more threads only synchronise
    try:
        with lcp_recording() if record else contextlib.nullcontext() as rec:
            for _ in range(MESH_PARITY_STEPS[name]):
                st = stepper.step(scene, st, GEOM_DT, device=device)
                pos.append(st.pos)
                pt = kinematics.compute(scene, st)
                _, con = nph.narrow_phase(scene, pt.pos, pt.quat,
                                          scene.contact_dist_thresh)
                most = max(most, int((con.active & plane_slots).sum(dim=1).max()))
    finally:
        torch.set_num_threads(threads)
    if rec is not None:
        rec["n_vars"] = scene.n_vars
    return torch.stack(pos).double().cpu(), most, rec


def merged_calls(calls):
    """Recorded LCP calls [(origin, M, q, mask, z0), ...] with work, each
    origin's merged into one batch (a missing z0 as zeros, which `ppm_lcp`
    reads as a cold start, as it reads None)."""
    out = []
    for who in sorted({c[0] for c in calls}):
        mine = [c for c in calls if c[0] == who and bool(c[3].any())]
        if not mine:
            continue
        assert len({c[1].shape[1:] for c in mine}) == 1, f"{who}: LCP sizes differ"
        out.append((who, torch.cat([c[1] for c in mine]), torch.cat([c[2] for c in mine]),
                    torch.cat([c[3] for c in mine]),
                    torch.cat([torch.zeros_like(c[2]) if c[4] is None else c[4]
                               for c in mine])))
    return out


_MESH_XML = """<XML>
<DRIVER step-size="0.001" />
<MOBY>
  <TriangleMesh id="lm" filename="l.obj" density="2.0" />
  <TriangleMesh id="cm" filename="cube.obj" center="false" mass="1.5" />
  <TriangleMeshInline id="tet" vertices="0 0 0  0.4 0 0  0 0.4 0  0 0 0.4"
      faces="0 2 1  0 1 3  0 3 2  1 2 3" mass="1.2" />
  <Plane id="p" />
  <GravityForce id="g" accel="0 0 -9.81" />
  <RigidBody id="L" position="0 0 0.8335">
    <InertiaFromPrimitive primitive-id="lm" /><CollisionGeometry primitive-id="lm" />
  </RigidBody>
  <RigidBody id="cube" position="4 0 0.4002">
    <InertiaFromPrimitive primitive-id="cm" /><CollisionGeometry primitive-id="cm" />
  </RigidBody>
  <RigidBody id="tet" position="8 0 0.0002">
    <InertiaFromPrimitive primitive-id="tet" /><CollisionGeometry primitive-id="tet" />
  </RigidBody>
  <RigidBody id="ground" enabled="false"><CollisionGeometry primitive-id="p" /></RigidBody>
  <TimeSteppingSimulator>
    <DynamicBody dynamic-body-id="L" /><DynamicBody dynamic-body-id="cube" />
    <DynamicBody dynamic-body-id="tet" /><DynamicBody dynamic-body-id="ground" />
    <RecurrentForce recurrent-force-id="g" />
    <ContactParameters object1-id="ground" object2-id="L" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="cube" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="tet" mu-coulomb="0.5" epsilon="0" />
    <DisabledPair object1-id="L" object2-id="cube" />
    <DisabledPair object1-id="L" object2-id="tet" />
    <DisabledPair object1-id="cube" object2-id="tet" />
  </TimeSteppingSimulator>
</MOBY></XML>"""


def _obj_text(verts, faces):
    return "".join(f"v {float(x)!r} {float(y)!r} {float(z)!r}\n" for x, y, z in verts) + "".join(
        f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)


def write_mesh_scene(directory):
    """A Moby XML scene of the mesh tags, its OBJs beside it: the L-prism as
    a <TriangleMesh> centred on its COM (its mass from `density`), a cube as
    a <TriangleMesh> with center="false" 0.1 m off its origin, and a
    tetrahedron as a <TriangleMeshInline>, each 0.2 mm above one plane, their
    mutual pairs disabled. Returns the scene's path."""
    from moby_tpu_torch.geometry import trimesh

    lv, lf = trimesh.extrude_polygon(L_POLY, -0.5, 0.5)
    with open(os.path.join(directory, "l.obj"), "w") as f:
        f.write(_obj_text(lv + [0.3, 0.0, 0.0], lf))
    cv, cf = cube_mesh(0.4)
    with open(os.path.join(directory, "cube.obj"), "w") as f:
        f.write(_obj_text(cv + [0.1, 0.0, 0.0], cf))
    path = os.path.join(directory, "meshes.xml")
    with open(path, "w") as f:
        f.write(_MESH_XML)
    return path


def phase_mesh_parity(seed):
    """Card float32 against the port on the CPU in float64 for every mesh
    configuration at GEOM_PARITY_BATCH over MESH_PARITY_STEPS: no NaN, the
    largest position drift within MESH_DRIFT_LIMIT, and no plane pair with
    more active slots than VSLOT_CAP (the big icosphere's 642 vertices);
    then the regress CLI on an XML scene of the mesh tags written into a
    temporary directory, GEOM_REGRESS_STEPS steps on the card and with --cpu,
    compared within REGRESS_TOL. The stack's card run records what it hands
    `ppm_lcp` (MESH_TIMED: it has no timed run), each LCP origin's calls
    merged into one batch. Returns that record, as `phase_kernels_models`
    reads it."""
    from moby_tpu_torch.core import scene as sc

    stack = None
    for name in MESH_SCENES:
        t0 = time.time()
        pc, most_c, rec = mesh_parity_run(name, DEVICE, seed + 1,
                                          record=name == "meshstack")
        t1 = time.time()
        pr, most_r, _ = mesh_parity_run(name, "cpu", seed + 1)
        drift = float((pc - pr).abs().max())
        log(f"[trimeshparity] {name}: B={GEOM_PARITY_BATCH} steps="
            f"{MESH_PARITY_STEPS[name]}: max position drift {drift:.3e} (limit "
            f"{MESH_DRIFT_LIMIT[name]:.2e}); most active slots of a plane pair card "
            f"{most_c}, CPU {most_r} (cap {sc.VSLOT_CAP}); card {t1 - t0:.1f} s, CPU "
            f"{time.time() - t1:.1f} s")
        assert torch.isfinite(pc).all(), f"trimeshparity {name}: not finite"
        assert max(most_c, most_r) <= sc.VSLOT_CAP, f"trimeshparity {name}: {most_c} slots"
        assert drift < MESH_DRIFT_LIMIT[name], f"trimeshparity {name}: drift {drift:.3e}"
        if rec is not None:
            calls, with_work = kernel_work(rec["recorded"])
            log(f"[trimeshparity] {name}: ppm_lcp launches={rec['launches']}, calls "
                f"with work={calls}, problems with work by LCP={with_work}")
            stack = {"recorded": merged_calls(rec["recorded"]),
                     "entered": merged_calls(rec["entered"]), "n_vars": rec["n_vars"]}

    regress_card_against_cpu("trimeshparity", write_mesh_scene,
                             "the mesh scene (TriangleMesh from two OBJs, TriangleMeshInline)")
    return stack


def phase_regress():
    """The port's regress CLI on the repo's two scenes, on the card and with
    `--cpu`, REGRESS_STEPS steps of REGRESS_DT each; the dumps compared by
    the port's compare within REGRESS_TOL. (The sitting box's float32 run
    rests 2·NEAR_ZERO = 6.9e-4 m higher: float32 stabilization parks it
    there.)"""
    from moby_tpu_torch.cli import compare, regress

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "moby_tpu_torch", "build", "regress")
    os.makedirs(out_dir, exist_ok=True)
    errs = {}
    for xml, n_steps in REGRESS_STEPS.items():
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes", xml)
        dumps, secs = {}, {}
        for mode in ("card", "cpu"):
            dumps[mode] = os.path.join(out_dir, f"{xml[:-4]}.{mode}.dat")
            argv = [f"-s={REGRESS_DT}", f"-mi={n_steps}", path, dumps[mode]]
            t0 = time.time()
            assert regress.main(argv + (["--cpu"] if mode == "cpu" else [])) == 0
            secs[mode] = time.time() - t0
        err, where, n = compare.compare(dumps["cpu"], dumps["card"])
        errs[xml] = err
        log(f"[regress] {xml}: {n} lines, card float32 against --cpu float64 L-inf "
            f"{err:.3e} (worst at line, column {where}; limit {REGRESS_TOL:.0e}); "
            f"card {secs['card']:.1f} s, CPU {secs['cpu']:.1f} s")
        assert n == n_steps, f"regress {xml}: {n} lines"
        assert compare.main([dumps["cpu"], dumps["card"], str(REGRESS_TOL)]) == 0, (
            f"regress {xml}: {err:.3e}")
    return errs


def time_ppm_calls(calls, label):
    """`ppm_lcp` on a path's own calls (who, M, q, mask, z0), timed beside
    the plain version and the bound, the kernel alone from the profiler."""
    from moby_tpu_torch.solvers import hopper_lcp

    ms = plain_ms = bnd = 0.0
    by = {"bytes": 0, "operations": 0}
    pivots = 0
    for (_, M, q, mask, z0) in calls:
        _, _, piv, sizes = hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0,
                                                    with_pivots=True)
        pivots += int(piv.sum())
        ms += time_cuda(lambda: hopper_lcp.ppm_lcp(M, q, mask, z0=z0), 20)
        plain_ms += time_cuda(
            lambda: hopper_lcp.ppm_lcp_plain(M, q, mask, z0=z0), 2, warmup=1)
        b, which = bound_ms(M, mask, z0, piv, sizes)
        bnd += b
        by[which] += 1
    _, M0, q0, m0, z00 = calls[0]
    k = len(calls)
    out = {"calls": k, "problems_with_work": sum(int(c[3].any(dim=1).sum()) for c in calls),
           "pivots": pivots, "ms": ms / k, "plain_ms": plain_ms / k,
           "bound_ms": bnd / k, "bound_by": max(by, key=by.get),
           "device_ms": device_ms(lambda: hopper_lcp.ppm_lcp(M0, q0, m0, z0=z00))}
    log(f"[timing] ppm_lcp on {label}: {out}")
    return out


def measure_art_kernel(art):
    """`ppm_lcp` on the table path's own calls: the calls with a non-empty
    mask (all of them if none had one), timed beside the plain version and
    the bound, the kernel alone from the profiler; and the same kernel on
    the LCPs as they entered `_solve_accel` (every problem with work, cold)."""
    from moby_tpu_torch.solvers import hopper_lcp

    with_work = [r for r in art["recorded"] if bool(r[3].any())]
    picks = (with_work or art["recorded"])[:8]
    entry = {
        "launches": art["launches"], "launches_per_step": art["launches"] / ART_STEPS,
        "problems_with_work": art["nonempty"], "n": picks[0][1].shape[1],
        "path": art["plan"].path, "stages": art["stages"],
        "scenario_steps_per_s": art["rate"],
        "timed_on": time_ppm_calls(
            picks, f"{len(picks)} of the table path's calls"
            + (" with work" if with_work else " (none had work)")),
    }
    none = torch.zeros_like(picks[0][3])
    _, Mf, qf, _, zf = picks[0]
    entry["launch_floor"] = {
        "shape": f"B={none.shape[0]} n={none.shape[1]} all-false mask",
        "device_ms": device_ms(lambda: hopper_lcp.ppm_lcp(Mf, qf, none, z0=zf)),
        "bound_ms": bound_ms(Mf, none, None, torch.zeros(len(none), device=DEVICE),
                             torch.zeros((0, len(none)), device=DEVICE))[0],
    }
    full = [r for r in art["entered"] if bool(r[3].any())][:4]
    entry["entered_lcps_cold"] = time_ppm_calls(
        [(w, M, q, m, None) for (w, M, q, m, _) in full],
        f"{len(full)} of the LCPs that entered the cascade, every problem with work, cold")
    return entry


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


def device_ms(fn, reps=20, kernel="ppm_lcp_"):
    """Mean device time of the named kernel alone over `reps` calls of fn, from
    torch.profiler's kernel records (the wrapper's host work and its mask
    conversion are left out). The card's kernel records can reach the
    profiler seconds after the kernels have ended, and a profile closed
    before that has the launches without their kernels. So the profile stays
    open a quarter of a second after the synchronise, and is taken again with
    a wait of 1, 4 and 8 s if it has none. None if none had: the output then
    says "not measured" and nothing fails, since the wait has no known bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt, wait in enumerate((0.25, 1.0, 4.0, 8.0)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(wait)
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                if us > 0:
                    total_us += us
                    count += ev.count
        if count:
            return total_us / count / 1e3
        seen = [(ev.key[:60], ev.count) for ev in prof.key_averages()
                if "kernel" in ev.key.lower()]
        log(f"[timing] profile {attempt + 1} recorded no {kernel}; kernels it saw: {seen}")
    log(f"[timing] device time of {kernel}: not measured")
    return None


def bpp_bound_ms(M, mask, z0, solves, nb_sizes):
    """As `bound_ms`, for one float32 `bpp_lcp` call: `solves` (B,) is the
    block iterations plus the PPM pivots each problem took, `nb_sizes` the
    size of each solve's nonbasic system; the check adds one product M z over
    the m active rows, 2·m², for a problem that had anything to solve."""
    t, which = bound_ms(M, mask, z0, solves, nb_sizes)
    m = mask.sum(dim=1).double()
    check = float((2.0 * m * m)[solves > 0].sum()) / PEAK_F32_FLOPS * 1e3
    if which == "operations":
        return t + check, which
    k = nb_sizes.double()
    ops = float(((2.0 / 3.0) * k ** 3 + 2.0 * m[None, :] * k).sum()) / PEAK_F32_FLOPS * 1e3
    return (t, "bytes") if t >= ops + check else (ops + check, "operations")


def batched_pair(M, q, mask, z0, skip, max_iters, tol=None):
    """The batched `lcp_bpp` + `_verify` pair that one `bpp_lcp` launch stands
    for, as the cascades run it (at `tol`, else the tolerance of M)."""
    from moby_tpu_torch.solvers import lcp

    Mp, qp = lcp.pad_lcp(M, q, mask)
    if tol is None:
        tol = lcp._check_tol(Mp, mask)
    z, ok = lcp.lcp_bpp(M, q, mask, z0=z0, skip=skip, max_iters=max_iters)
    return z, ok & lcp._verify(Mp, qp, z, mask, tol)


def time_bpp_on(picks, label, hold=False):
    """Mean ms over `picks` [(M, q, mask, z0, max_bpp, check_tol)] of the kernel's wrapper
    call, the batched pair on the same problems (skip = empty mask), the plain
    version, and the bound; also how far kernel and pair agree. With `hold`
    the kernel must agree with its plain version (ok, and z within TOL) and
    with the batched pair (ok) on every problem of every pick."""
    from moby_tpu_torch.solvers import hopper_lcp

    ms = pair_ms = plain_ms = bnd = err = 0.0
    by = {"bytes": 0, "operations": 0}
    solves = agree = total = 0
    for (M, q, mask, z0, max_bpp, tol) in picks:
        skip = ~mask.any(dim=1)
        zp, okp, its, piv, sizes = hopper_lcp.bpp_lcp_plain(
            M, q, mask, z0=z0, max_bpp=max_bpp, check_tol=tol, with_pivots=True)
        zk, okk = hopper_lcp.bpp_lcp(M, q, mask, z0=z0, max_bpp=max_bpp, check_tol=tol)
        _, okb = batched_pair(M, q, mask, z0, skip, max_bpp, tol)
        agree += int((okk == (okb | skip)).sum())
        total += len(okk)
        if hold:
            assert bool((okk == okp).all()), (
                f"{label}: ok differs from the plain version's on "
                f"{int((okk != okp).sum())} of {len(okk)} problems")
            assert bool((okk == (okb | skip)).all()), (
                f"{label}: ok differs from the batched pair's on "
                f"{int((okk != (okb | skip)).sum())} of {len(okk)} problems")
            scale = max(1.0, float(zp.abs().max()))
            err = max(err, float((zk - zp).abs().max()) / scale)
            assert err <= TOL[M.dtype], (
                f"{label}: max|z_kernel - z_plain| = {err:.3e} of scale {scale:.3g}")
        solves += int((its + piv).sum())
        ms += time_cuda(lambda: hopper_lcp.bpp_lcp(M, q, mask, z0=z0, max_bpp=max_bpp,
                                                   check_tol=tol), 20)
        pair_ms += time_cuda(lambda: batched_pair(M, q, mask, z0, skip, max_bpp, tol), 3,
                             warmup=1)
        plain_ms += time_cuda(
            lambda: hopper_lcp.bpp_lcp_plain(M, q, mask, z0=z0, max_bpp=max_bpp,
                                             check_tol=tol), 2, warmup=1)
        b, which = bpp_bound_ms(M, mask, z0, its + piv, sizes)
        bnd += b
        by[which] += 1
    k = len(picks)
    out = {"calls": k, "ms": ms / k, "batched_bpp_verify_ms": pair_ms / k,
           "plain_ms": plain_ms / k, "bound_ms": bnd / k,
           "bound_by": max(by, key=by.get), "solves": solves,
           "ok_agrees_with_pair": f"{agree}/{total}"}
    if hold:
        out["max_rel_err_to_plain"] = err
    log(f"[timing] bpp_lcp on {label}: {out}")
    return out


def measure_bpp(mpc_recorded, stage1, launches, max_err):
    """Time `bpp_lcp` on the inputs the MPC path gave it (whole cascades: the
    stage-1 call with work and the three regularized calls after it, whose
    masks are empty when stage 1 solved everything) and on the step's
    recorded stage-1 problems, beside batched `lcp_bpp` + `_verify`, the plain
    version and the bound."""
    from moby_tpu_torch.solvers import hopper_lcp

    picks = mpc_recorded[:32]
    entry = {
        "name": "bpp_lcp", "route": "cuda", "source": BPP_SOURCE,
        "replaces": BPP_REPLACES, "launches": launches, "max_abs_err": max_err,
        "library_ms": None,     # no single PyTorch call computes an LCP
    }
    main = time_bpp_on(picks, f"{len(picks)} of the MPC path's calls", hold=True)
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "batched_bpp_verify_ms"):
        entry[key] = main[key]
    entry["timed_on"] = (f"{len(picks)} of the MPC path's {launches} calls "
                         f"(B={MPC_BATCH}, n={picks[0][0].shape[1]})")
    work = [r for r in picks if bool(r[2].any())]
    assert work, "mpc: no recorded call had a problem to solve"
    entry["mpc_calls_with_work"] = time_bpp_on(
        work, "the MPC calls with a non-empty mask", hold=True)
    M0, q0, m0, z00, mb0, t0 = work[0]
    entry["device_ms"] = device_ms(
        lambda: hopper_lcp.bpp_lcp(M0, q0, m0, z0=z00, max_bpp=mb0, check_tol=t0),
        kernel="bpp_lcp_")
    # the launch floor: the same call with an all-false mask, every group
    # leaves after reading its mask
    none = torch.zeros_like(m0)
    entry["launch_floor"] = {
        "shape": f"B={m0.shape[0]} n={m0.shape[1]} all-false mask",
        "device_ms": device_ms(
            lambda: hopper_lcp.bpp_lcp(M0, q0, none, z0=z00, max_bpp=mb0, check_tol=t0),
            kernel="bpp_lcp_"),
        "bound_ms": bound_ms(M0, none, None, torch.zeros(len(m0), device=DEVICE),
                             torch.zeros((0, len(m0)), device=DEVICE))[0],
    }
    log(f"[timing] bpp_lcp on a call with work: {entry['device_ms']} ms on the device; "
        f"launch floor {entry['launch_floor']}")
    if stage1:
        s1 = [(M.contiguous(), q.contiguous(),
               (mask if skip is None else mask & ~skip[:, None]).contiguous(),
               None if z0 is None else z0.contiguous(), 24, None)
              for (M, q, mask, z0, skip) in stage1]
        entry["step_stage1_problems"] = time_bpp_on(
            s1, f"{len(s1)} of the step's stage-1 problems "
                f"(n in {sorted({r[0].shape[1] for r in s1})})")
    return entry


def measure_block_kernel(block):
    """`bpp_lcp` on block-push's recorded stage-1 calls with work (n=64, the
    block path): the wrapper call beside the batched pair, the plain version
    and the bound; the kernel alone from the profiler; the launch floor."""
    from moby_tpu_torch.solvers import hopper_lcp

    picks = [r for r in block["recorded"] if bool(r[2].any())][:1]
    out = {"launches": block["launches"],
           "launches_by_mode": {k: m["bpp_lcp_launches"] for k, m in block["modes"].items()},
           "calls_with_work_by_mode": {k: m["calls_with_work"]
                                       for k, m in block["modes"].items()},
           "single_solve_launches": block["single"]["launches"],
           "ppm_reach": block.get("ppm_reach"),
           "path": hopper_lcp.launch_plan(64, torch.float32, BLOCK_BATCH).path}
    if not picks:
        log("[timing] bpp_lcp on block-push: no recorded call had work")
        return out
    out["timed_on"] = time_bpp_on(picks, f"{len(picks)} of block-push's stage-1 calls "
                                         f"with work (B={BLOCK_BATCH}, n=64)")
    M0, q0, m0, z00, mb0, t0 = picks[0]
    out["device_ms"] = device_ms(
        lambda: hopper_lcp.bpp_lcp(M0, q0, m0, z0=z00, max_bpp=mb0, check_tol=t0),
        kernel="bpp_lcp_")
    none = torch.zeros_like(m0)
    out["launch_floor"] = {
        "shape": f"B={m0.shape[0]} n={m0.shape[1]} all-false mask",
        "device_ms": device_ms(
            lambda: hopper_lcp.bpp_lcp(M0, q0, none, z0=z00, max_bpp=mb0, check_tol=t0),
            kernel="bpp_lcp_"),
        "bound_ms": bound_ms(M0, none, None, torch.zeros(len(m0), device=DEVICE),
                             torch.zeros((0, len(m0)), device=DEVICE))[0],
    }
    log(f"[timing] bpp_lcp on block-push: {out['device_ms']} ms on the device; "
        f"launch floor {out['launch_floor']}")
    return out


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
    # the launch floor at each of the main path's shapes: an all-false mask
    # (what every call of the main path had so far)
    floor = {}
    for nn in sorted({r[0].shape[1] for r in picks}):
        Mf, qf, mf, zf = next(r for r in picks if r[0].shape[1] == nn)
        none = torch.zeros_like(mf)
        floor[f"B={mf.shape[0]} n={nn}"] = {
            "device_ms": device_ms(lambda: hopper_lcp.ppm_lcp(Mf, qf, none, z0=zf)),
            "bound_ms": bound_ms(Mf, none, None, torch.zeros(len(mf), device=DEVICE),
                                 torch.zeros((0, len(mf)), device=DEVICE))[0],
        }
    log(f"[timing] ppm_lcp launch floor (all-false mask): {floor}")
    # the same kernel doing real work: every problem of a B=512, n=66
    # monotone batch pivots to its solution (float32, cold)
    M, q = monotone(BATCH, 66, 1, torch.float32)
    full = torch.ones(BATCH, 66, dtype=torch.bool, device=DEVICE)
    work_dev = device_ms(lambda: hopper_lcp.ppm_lcp(M, q, full), reps=5)
    _, _, piv, sizes = hopper_lcp.ppm_lcp_plain(M, q, full, with_pivots=True)
    work_ms = time_cuda(lambda: hopper_lcp.ppm_lcp(M, q, full), 10)
    work_plain = time_cuda(lambda: hopper_lcp.ppm_lcp_plain(M, q, full), 1, warmup=0)
    wb, wwhich = bound_ms(M, full, None, piv, sizes)
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
        "device_ms": main_dev, "launch_floor": floor,
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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the articulated phases' per-scenario spin")
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

    t_phase = [time.time()]

    def lap(name):
        now = time.time()
        log(f"[time] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    phase_build()          # every later phase needs the libraries
    lap("build")
    max_err = phase_kernels() if "kernels" in phases else None
    bpp_err = phase_kernels_bpp() if "kernels" in phases else None
    if "kernels" in phases:
        edge_err = phase_kernels_edges()
        max_err, bpp_err = max(max_err, edge_err), max(bpp_err, edge_err)
        lap("kernels")
    launches, recorded, rate, stage1 = (phase_step() if "step" in phases
                                        else (0, [], None, []))
    if "parity" in phases:
        phase_parity()
    lap("step, parity")
    mpc_launches, mpc_recorded, mpc_rate, _ = (phase_mpc() if "mpc" in phases
                                               else (0, [], None, None))
    if "mpcparity" in phases:
        phase_mpc_parity()
    lap("mpc, mpcparity")
    block = phase_block(args.seed) if "block" in phases else None
    lap("block")
    if block is not None and "blockparity" in phases:
        phase_block_parity(block)
        lap("blockparity")
    if block is not None and "kernels" in phases:
        bpp_err = max(bpp_err, phase_kernels_block(block))
        lap("kernels on block-push's LCPs")
    if "artmpc" in phases:
        phase_art_mpc(args.seed)
        lap("artmpc")
    art = phase_art(args.seed) if "art" in phases else None
    lap("art")
    if "artparity" in phases:
        phase_art_parity(args.seed)
        lap("artparity")
    if art is not None and "kernels" in phases:
        art_err = phase_kernels_art(art)
        max_err = max(max_err, art_err)
        lap("kernels on the table's LCPs")
    models = phase_models(args.seed) if "models" in phases else None
    lap("models")
    if "modelsparity" in phases:
        phase_models_parity(args.seed)
        lap("modelsparity")
    if "regress" in phases:
        phase_regress()
        lap("regress")
    if models is not None and "kernels" in phases:
        max_err = max(max_err, phase_kernels_models(models))
        lap("kernels on the models' LCPs")
    geometry = phase_geometry(args.seed) if "geometry" in phases else None
    lap("geometry")
    if "geometryparity" in phases:
        phase_geometry_parity(args.seed)
        lap("geometryparity")
    if geometry is not None and "kernels" in phases:
        max_err = max(max_err, phase_kernels_models(
            geometry, {k: r["n_vars"] for k, r in geometry.items()}))
        lap("kernels on the geometry's LCPs")
    mesh = phase_mesh(args.seed) if "trimesh" in phases else None
    lap("trimesh")
    stack = phase_mesh_parity(args.seed) if "trimeshparity" in phases else None
    lap("trimeshparity")
    if mesh is not None and "kernels" in phases:
        max_err = max(max_err, phase_kernels_models(
            mesh, {k: r["n_vars"] for k, r in mesh.items()}))
    if stack is not None and "kernels" in phases:
        # its singular float32 LCPs: done may fail complementarity where the
        # plain version's does (`both_versions`)
        max_err = max(max_err, phase_kernels_models(
            {"meshstack": stack}, {"meshstack": stack["n_vars"]}, verify="as_plain"))
    lap("kernels on the meshes' LCPs")
    full_run = set(phases) == set(PHASES)
    entries = []
    table_path = measure_art_kernel(art) if art is not None else None
    models_path = measure_models_kernel(models) if models is not None else None
    geometry_path = (measure_models_kernel(geometry, "the geometry's")
                     if geometry is not None else None)
    mesh_path = (measure_models_kernel(mesh, "the meshes'")
                 if mesh is not None else None)
    if recorded:
        entry = measure_kernel(recorded, launches, max_err)
        # the step's, the table's and each model's runs, each counted from 0
        entry["launches_by_path"] = {"step": launches}
        if table_path is not None:
            entry["launches_by_path"]["table"] = art["launches"]
            entry["table_path"] = table_path
        if models_path is not None:
            entry["launches_by_path"].update(
                {f"models:{k}": r["launches"] for k, r in models.items()})
            entry["models_path"] = models_path
        if geometry_path is not None:
            entry["launches_by_path"].update(
                {f"geometry:{k}": r["launches"] for k, r in geometry.items()})
            entry["geometry_path"] = geometry_path
        if mesh_path is not None:
            entry["launches_by_path"].update(
                {f"trimesh:{k}": r["launches"] for k, r in mesh.items()})
            entry["mesh_path"] = mesh_path
        entry["launches"] = sum(entry["launches_by_path"].values())
        entries.append(entry)
    else:
        for label, path in (("the table path", table_path),
                            ("the models' paths", models_path),
                            ("the geometry's paths", geometry_path),
                            ("the meshes' paths", mesh_path)):
            if path is not None:
                log(f"[timing] ppm_lcp on {label}: {json.dumps(path)}")
    block_path = measure_block_kernel(block) if block is not None else None
    if mpc_recorded:
        entry = measure_bpp(mpc_recorded, stage1, mpc_launches, bpp_err)
        if block_path is not None:
            # ball-push's and block-push's runs, each counted from 0
            entry["launches_by_path"] = {"ballpush": mpc_launches,
                                         "blockpush": block["launches"]}
            entry["launches"] = mpc_launches + block["launches"]
            entry["block_path"] = block_path
        entries.append(entry)
    elif block_path is not None:
        log(f"[timing] bpp_lcp on the block-push path: {json.dumps(block_path)}")
    if full_run:
        assert len(entries) == 2 and all(e["launches"] > 0 for e in entries), (
            "a kernel of the main paths was never launched")
        assert art["launches"] > 0, "the table path never launched ppm_lcp"
        assert all(r["launches"] > 0 for r in models.values()), (
            "a path of the other contact models never launched ppm_lcp")
        assert all(r["launches"] > 0 for r in geometry.values()), (
            "a geometry path never launched ppm_lcp")
        assert all(r["launches"] > 0 for r in mesh.values()), (
            "a mesh path never launched ppm_lcp")
        assert block["launches"] > 0, "the block-push path never launched bpp_lcp"
    lap("timing")
    if entries:
        log(json.dumps({"kernels": entries}))
    log(f"[done] {time.time() - t_start:.1f} s; scenario-steps/s at B={BATCH}: {rate}; "
        f"MPC solves/s at B={MPC_BATCH}: {mpc_rate}; block-push solves/s at "
        f"B={BLOCK_BATCH}: "
        f"{None if block is None else {k: round(m['solves_per_s'], 2) for k, m in block['modes'].items()}}; "
        f"table scenario-steps/s at B={ART_BATCH}: {None if art is None else art['rate']}; "
        f"models' scenario-steps/s at B={MODELS_BATCH}: "
        f"{None if models is None else {k: round(r['rate'], 1) for k, r in models.items()}}; "
        f"geometry's scenario-steps/s at B={GEOM_BATCH}: "
        f"{None if geometry is None else {k: round(r['rate'], 1) for k, r in geometry.items()}}; "
        f"meshes' scenario-steps/s at B={GEOM_BATCH}: "
        f"{None if mesh is None else {k: round(r['rate'], 1) for k, r in mesh.items()}}")
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
