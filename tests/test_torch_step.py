"""PyTorch port: the contact step as a whole — `moby_tpu_torch.sim.stepper`
against `jax.vmap(moby_tpu.sim.stepper.step)`, float64, batched scenarios
with per-scenario height jitter made with numpy from a seed.

Positions, quaternions, velocities and the warm-start `zlast` are held to
L∞ <= 1e-9 over the whole rollout. (The box scene's contact manifold is
redundant — four coplanar vertices — so its LCP's z is not unique and a
singular LU may take another pivot path to the same impulses: its `zlast`
is not compared, its trajectory is.)
"""

import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.sim import stepper as jstep
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.sim import stepper as tstep
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    batch_jax_state, batch_torch_state, build_ballpush, build_box_on_box,
    build_box_on_plane, build_stack, t2n, torch_scene_state,
)

B = 3
DT = 1e-3
FIELDS = ("pos", "quat", "vel", "omega", "time", "min_dist_obs")


def _rollout_both(make_scene, n_steps, cascade, dz_scale, own_compile=False):
    jscene, jstate = make_scene(jsc).compile()
    if own_compile:
        tscene, tstate = make_scene(tsc).compile(device="cpu")
    else:
        tscene, tstate = torch_scene_state(jscene, jstate)
    rng = np.random.default_rng(0)
    dz = rng.uniform(size=(B, jscene.nb)) * dz_scale
    dz[:, -1] = 0.0
    js = batch_jax_state(jstate, B, dz)
    ts = batch_torch_state(tstate, B, dz)
    jstep_fn = jax.jit(jax.vmap(lambda s: jstep.step(jscene, s, DT)))
    errs = {f: 0.0 for f in FIELDS + ("zlast",)}
    pivots = 0
    for _ in range(n_steps):
        js = jstep_fn(js)
        ts = tstep.step(tscene, ts, DT, device="cpu", cascade=cascade)
        for f in errs:
            errs[f] = max(errs[f], float(np.abs(
                np.asarray(getattr(js, f)) - t2n(getattr(ts, f))).max()))
        np.testing.assert_array_equal(t2n(ts.zlast_active),
                                      np.asarray(js.zlast_active))
        pivots += int(np.asarray(js.solver_pivots).sum())
    return js, ts, errs, pivots


@pytest.mark.parametrize("nk,cascade,own", [
    (4, None, False), (16, None, True), (4, "accel", True)],
    ids=["nk4_plain", "nk16_plain_own_compile", "nk4_accel_own_compile"])
def test_stack_step_matches_jax(nk, cascade, own):
    js, ts, errs, pivots = _rollout_both(
        lambda sc: build_stack(sc, nk=nk), 30, cascade, 0.01, own_compile=own)
    assert pivots > 0                     # impacts were really solved
    assert max(errs.values()) <= 1e-9, errs
    np.testing.assert_array_equal(t2n(ts.solver_pivots), np.asarray(js.solver_pivots))
    assert ts.batch == B and ts.zlast.shape == (B, {4: 48, 16: 66}[nk])
    # the stack stays a stack
    z = t2n(ts.pos)[:, :3, 2]
    assert np.all(np.diff(z, axis=1) > 1.99) and np.all(z[:, 0] > 0.99)


def test_box_on_plane_step_matches_jax():
    js, ts, errs, pivots = _rollout_both(build_box_on_plane, 25, None, 0.001)
    assert pivots > 0
    errs.pop("zlast")
    assert max(errs.values()) <= 1e-9, errs


def test_box_on_box_step_matches_jax():
    """Box-box contact, the pair capped at 6 slots (the deepest-vertex
    route): the manifold is small enough for z to be unique, so `zlast` is
    held to 1e-9 with the rest."""
    js, ts, errs, pivots = _rollout_both(
        lambda sc: build_box_on_box(sc, max_slots=6), 25, None, 0.001)
    assert pivots > 0
    assert max(errs.values()) <= 1e-9, errs


def test_rollout_and_controller():
    """`rollout` stacks the trajectory; the controller hook's wrench is
    applied (a lift equal to weight keeps the top sphere's velocity)."""
    scene, st = build_stack(tsc, nk=4).compile(device="cpu")
    st = st.expand(2)
    pos = st.pos.clone()
    pos[:, 2, 2] += 1.0                      # top sphere in free flight
    st = st.replace(pos=pos)

    def lift(scene_, s):
        u = s.pos.new_zeros((s.batch, scene_.ngc))
        u[1, 6 * 2 + 2] = 9.81               # scenario 1 only
        return u

    fin, (p, q, qa) = tstep.rollout(scene, st, DT, 5, controller=lift, device="cpu")
    assert p.shape == (5, 2, 4, 3) and q.shape == (5, 2, 4, 4) and qa.shape == (5, 2, 0)
    assert abs(float(fin.vel[1, 2, 2])) < 1e-12
    assert float(fin.vel[0, 2, 2]) == pytest.approx(-9.81 * 5 * DT, rel=1e-9)
    torch.testing.assert_close(p[-1], fin.pos)


def test_step_refuses_other_device_and_unported_models():
    scene, st = build_stack(tsc, nk=4).compile(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, ValueError)):
            tstep.step(scene, st, DT)            # default device is the card

    def one_pair(cp):
        b = build_ballpush(tsc)
        b.set_contact_params("ground", "ball", cp)
        return b.compile(device="cpu")

    # the no-slip model (every mu >= 100) is ported: it steps
    noslip, st2 = one_pair(tsc.ContactParams(mu_coulomb=200.0))
    assert noslip.use_noslip
    st2 = tstep.step(noslip, st2, DT, device="cpu")
    assert torch.isfinite(st2.pos).all() and float(st2.time[0]) == pytest.approx(DT)
    # so are the true cone (NQP) and per-island mixed routing
    nqp, st3 = one_pair(tsc.ContactParams(mu_coulomb=0.5, nk=0))
    assert nqp.use_nqp and not nqp.mixed_models
    st3 = tstep.step(nqp, st3, DT, device="cpu")
    assert torch.isfinite(st3.pos).all() and int(st3.solver_pivots[0]) > 0
    mixed, st4 = build_stack(tsc, nk=4, mu=200.0).compile(device="cpu")
    assert mixed.mixed_models
    st4 = tstep.step(mixed, st4, DT, device="cpu")
    assert torch.isfinite(st4.pos).all() and float(st4.time[0]) == pytest.approx(DT)
    # the legacy velocity-first step is still refused
    legacy = scene.replace(legacy_velocity_first=True)
    with pytest.raises(NotImplementedError, match="legacy"):
        tstep.step(legacy, st, DT, device="cpu")


def test_import_pulls_in_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "import moby_tpu_torch\n"
        "from moby_tpu_torch import config\n"
        "from moby_tpu_torch.core import scene\n"
        "from moby_tpu_torch.sim import stepper, impact, stabilization, kinematics\n"
        "from moby_tpu_torch.sim import nqp, bilateral\n"
        "from moby_tpu_torch.cli import regress, compare\n"
        "from moby_tpu_torch.solvers import lcp, hopper_lcp\n"
        "from moby_tpu_torch.geometry import narrowphase\n"
        "from moby_tpu_torch.math import quaternion, so3, spatial, linalg\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'moby_tpu', 'triton', 'ctypes')\n"
        "       if m in sys.modules and m != 'ctypes']\n"
        "assert not bad, bad\n"
        "assert hopper_lcp._libs is None\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
