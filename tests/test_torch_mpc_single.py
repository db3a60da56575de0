"""PyTorch port: single-scenario contact-MPC — `moby_tpu_torch.mpc.ilqr.ilqr`
and `contact_mpc.solve` against the JAX package's `ilqr.ilqr` and
`contact_mpc.solve`, float64 on the CPU.

Tasks: the double integrator of tests/test_mpc.py (20 steps, 15
iterations), ball-push (H=6, 3 iterations) and the block-push example
(`examples/block_push_mpc.py`: H=4, 2 iterations), each with the parallel
and the sequential line search. The JAX package's two line searches accept
the same step by construction; on the contact tasks the JAX side runs the
parallel one only (each JAX solve compiles for half a minute), and the
port's sequential line search is held to it.

Tolerances: the final cost to 1e-9 relative (the same iterations accept the
same step sizes). Controls and states: 1e-9 relative to their largest entry
on the double integrator and ball-push; 1e-6 on block-push, whose four
coplanar bottom contacts make the active block of its n=64 LCP singular to
working precision, so the Tikhonov-regularized IFT inverse amplifies
rounding: the JAX package's own jacfwd and jacrev of that step differ by
about 3e-9 (see tests/test_torch_mpc_linearize.py), and the Riccati gains
carry that into the controls.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.mpc import contact_mpc as jmpc
from moby_tpu.mpc import ilqr as jilqr
from moby_tpu_torch.mpc import contact_mpc as tmpc
from moby_tpu_torch.mpc import ilqr as tilqr
from moby_tpu_torch.mpc import MPCOptions
from moby_tpu_torch.solvers import hopper_lcp, lcp as tlcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (ballpush_both, ballpush_costs, blockpush_both,
                                blockpush_costs, ilqr_arrays)

DT = 0.02


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1e-300, np.abs(np.asarray(want)).max()))


def _hold(got, want, traj_tol, what):
    (gu, gx, gc), (wu, wx, wc) = got, want
    assert np.isfinite(gc) and np.isfinite(wc)
    assert gu.shape == wu.shape and gx.shape == wx.shape and np.ndim(gc) == 0
    assert _rel(gc, wc) <= 1e-9, f"{what}: cost {gc} against {wc}"
    assert _rel(gu, wu) <= traj_tol, f"{what}: us differ by {_rel(gu, wu):.3e}"
    assert _rel(gx, wx) <= traj_tol, f"{what}: xs differ by {_rel(gx, wx):.3e}"


# ------------------------------------------------------------ double integrator
@pytest.mark.parametrize("parallel", [True, False])
def test_double_integrator_matches_jax(parallel):
    dt = 0.1

    def jf(x, u):
        return jnp.array([x[0] + dt * x[1], x[1] + dt * u[0]])

    def jcost(x, u):
        return 0.01 * u[0] ** 2

    def jfinal(x):
        return 100.0 * ((x[0] - 1.0) ** 2 + x[1] ** 2)

    def tf(x, u):
        return torch.stack([x[:, 0] + dt * x[:, 1], x[:, 1] + dt * u[:, 0]], dim=1)

    def tcost(x, u):
        return 0.01 * u[:, 0] ** 2

    def tfinal(x):
        return 100.0 * ((x[:, 0] - 1.0) ** 2 + x[:, 1] ** 2)

    want = ilqr_arrays(jilqr.ilqr(jf, jcost, jfinal, jnp.zeros(2), jnp.zeros((20, 1)),
                                  n_iters=15, parallel_line_search=parallel))
    res = tilqr.ilqr(tf, tcost, tfinal, torch.zeros(2, dtype=torch.float64),
                     torch.zeros(20, 1, dtype=torch.float64), n_iters=15,
                     parallel_line_search=parallel)
    assert res.n_iters == 15
    got = ilqr_arrays(res)
    _hold(got, want, 1e-9, "double integrator")
    assert abs(got[1][-1, 0] - 1.0) < 1e-2 and abs(got[1][-1, 1]) < 5e-2


# ------------------------------------------------------------------ ball-push
@pytest.fixture(scope="module")
def ballpush():
    jscene, jstate, _, tscene, tstate, _, _ = ballpush_both(1)
    jcost, jfinal, tcost, tfinal = ballpush_costs()
    H = 6
    jf = jmpc.make_dynamics(jscene, jstate, DT)
    jx0 = jmpc.pack(jscene, jstate)
    want = ilqr_arrays(jilqr.ilqr(jf, jcost, jfinal, jx0, jnp.zeros((H, 6)),
                                  n_iters=3))
    return tscene, tstate, tcost, tfinal, H, want


@pytest.mark.parametrize("parallel", [True, False])
def test_ballpush_ilqr_matches_jax(parallel, ballpush):
    tscene, tstate, tcost, tfinal, H, want = ballpush
    tf = tmpc.make_dynamics(tscene, tstate, DT)
    x0 = tmpc.pack(tscene, tstate)[0]
    got = ilqr_arrays(tilqr.ilqr(tf, tcost, tfinal, x0,
                                 torch.zeros(H, 6, dtype=torch.float64), n_iters=3,
                                 parallel_line_search=parallel))
    _hold(got, want, 1e-9, "ball-push")
    assert got[2] < float(tfinal(x0[None]))      # the ball was pushed


# ----------------------------------------------------------------- block-push
H_BLOCK, ITERS_BLOCK = 4, 2


@pytest.fixture(scope="module")
def blockpush():
    jscene, jstate, tscene, tstate = blockpush_both()
    jcost, jfinal, tcost, tfinal = blockpush_costs()
    jprob = jmpc.MPCProblem(scene=jscene, template=jstate, dt=DT, horizon=H_BLOCK)
    want = ilqr_arrays(jmpc.solve(jprob, jstate, jcost, jfinal, n_iters=ITERS_BLOCK))
    tprob = tmpc.MPCProblem(scene=tscene, template=tstate, dt=DT, horizon=H_BLOCK)
    return tprob, tstate, tcost, tfinal, want


@pytest.mark.parametrize("parallel", [True, False])
def test_blockpush_solve_matches_jax(parallel, blockpush):
    tprob, tstate, tcost, tfinal, want = blockpush
    assert tprob.scene.n_lcp == 64 and tprob.scene.n_contacts == 8
    res = tmpc.solve(tprob, tstate, tcost, tfinal, n_iters=ITERS_BLOCK,
                     parallel_line_search=parallel, device="cpu")
    got = ilqr_arrays(res)
    assert got[0].shape == (H_BLOCK, 6) and got[1].shape == (H_BLOCK + 1, 13)
    _hold(got, want, 1e-6, "block-push")
    # the block moved toward the target and stayed on the plane
    assert got[2] < float(tfinal(tmpc.pack(tprob.scene, tstate)))
    assert got[1][:, 2].min() > 0.2 - 1e-3


def test_blockpush_kernel_route_with_the_plain_mirrors(blockpush):
    """cascade="accel" on CPU tensors: every block-pivoting pair of the MPC
    cascade goes through `hopper_lcp.bpp_lcp`, whose plain version stands in
    for the kernel, on block-push's n=64 LCPs, which the card runs on the
    kernel's block path (one thread block a problem). One iteration over a
    horizon of 2, the same solve as the batched route."""
    tprob, tstate, tcost, tfinal, _ = blockpush
    tprob = tprob._replace(horizon=2)
    calls = []
    real = hopper_lcp.bpp_lcp

    def spy(M, q, mask, *a, **k):
        calls.append((M.shape[0], M.shape[1], int(mask.any(dim=1).sum())))
        return real(M, q, mask, *a, **k)

    hopper_lcp.bpp_lcp = spy
    try:
        got = ilqr_arrays(tmpc.solve(tprob, tstate, tcost, tfinal, n_iters=1,
                                     options=MPCOptions(cascade="accel"), device="cpu"))
    finally:
        hopper_lcp.bpp_lcp = real
    want = ilqr_arrays(tmpc.solve(tprob, tstate, tcost, tfinal, n_iters=1,
                                  options=MPCOptions(cascade="plain"), device="cpu"))
    _hold(got, want, 1e-6, "block-push, kernel route")
    assert calls and {c[1] for c in calls} == {64}
    # backward sweeps (13 replicas), rollouts (1) and line searches (8)
    assert {c[0] for c in calls} >= {1, 8, 13}
    assert sum(c[2] for c in calls) > 0
    for B in {c[0] for c in calls}:
        assert hopper_lcp.launch_plan(64, torch.float32, B).path == "block"


def test_blockpush_float64_done_is_decided_by_rounding(blockpush):
    """Why the card's float64 `bpp_lcp` and `bpp_lcp_plain` cannot be held to
    the same `done` on block-push's LCPs: the four coplanar bottom contacts
    make the block-pivoting system M_FF singular, and its elimination meets
    a pivot that is exactly 0 in one rounding (the step is skipped) and
    about 1e-17·‖M‖∞ in another (the step divides by it). Perturbing M by
    1e-15 relative, the size of the difference between the kernel's fused,
    unscaled elimination and the plain version's, changes whether many
    problems finish; every problem that finishes is a verified solution."""
    tprob, tstate, _, _, _ = blockpush
    scene = tprob.scene
    B = 32
    rng = np.random.default_rng(7)
    st = tstate.expand(B)
    pos = st.pos.clone()
    pos[:, 0, :2] += torch.tensor(rng.uniform(-0.05, 0.05, size=(B, 2)))
    st = st.replace(pos=pos)
    u = torch.zeros(B, 6, dtype=torch.float64)
    u[:, :2] = torch.tensor(rng.uniform(-2.0, 2.0, size=(B, 2)))
    u[:, 3:] = torch.tensor(rng.uniform(-0.2, 0.2, size=(B, 3)))
    calls = []
    real = hopper_lcp.bpp_lcp

    def spy(M, q, mask, z0=None, max_bpp=24, **k):
        calls.append((M, q, mask, z0, max_bpp))
        return real(M, q, mask, z0=z0, max_bpp=max_bpp, **k)

    f = tmpc.make_dynamics(scene, tstate, DT, MPCOptions(cascade="accel"))
    hopper_lcp.bpp_lcp = spy
    try:
        with torch.no_grad():
            f(tmpc.pack(scene, st), u)
    finally:
        hopper_lcp.bpp_lcp = real
    M, q, mask, z0, mb = calls[0]                  # stage 1 of the step's solve
    assert M.shape == (B, 64, 64) and bool(mask.any(dim=1).all())
    noise = torch.randn(M.shape, generator=torch.Generator().manual_seed(1),
                        dtype=M.dtype)
    Mp, qp = tlcp.pad_lcp(M, q, mask)
    tol = tlcp._check_tol(Mp, mask)
    done = []
    for Mx in (M, M * (1 + 1e-15 * noise)):
        z, ok = hopper_lcp.bpp_lcp_plain(Mx, q, mask, z0=z0, max_bpp=mb)
        assert bool((~ok | tlcp._verify(Mp, qp, z, mask, tol)).all())
        done.append(ok)
    flips = int((done[0] != done[1]).sum())
    assert flips >= B // 4, f"only {flips} of {B} problems changed"


@pytest.mark.parametrize("B", [1, 8])
def test_quu_inverse_has_no_shape_special_case(B):
    """The single solve's Quu (batch 1) and the step-size batch of 8 take the
    same float32 Gauss–Jordan as the batched solve."""
    rng = np.random.default_rng(B)
    A = rng.normal(size=(B, 6, 6))
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)
    Mt = torch.tensor(M, dtype=torch.float32)
    inv, ok = tilqr._pd_inverse(Mt)
    assert inv.shape == (B, 6, 6) and bool(ok.all())
    np.testing.assert_allclose(inv.double().numpy(), np.linalg.inv(M), rtol=0,
                               atol=1e-3 * np.abs(np.linalg.inv(M)).max())
    inv2, ok2 = tlcp.gj_invert_pd(Mt)
    assert torch.equal(inv, inv2) and torch.equal(ok, ok2)


def test_solve_refuses_a_batch_and_another_device(blockpush):
    tprob, tstate, tcost, tfinal, _ = blockpush
    with pytest.raises(ValueError):
        tmpc.solve(tprob, tstate.expand(2), tcost, tfinal, n_iters=1, device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        tmpc.solve(tprob, tstate, tcost, tfinal, n_iters=1)      # device="cuda"
