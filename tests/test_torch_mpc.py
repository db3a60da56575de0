"""PyTorch port: contact-MPC as a whole — `moby_tpu_torch.mpc.contact_mpc.
solve_batch` on the ball-push task against the JAX package's `solve_batch`,
in the modes of tests/test_mpc_rr.py::TestRecordReplayParity (B=4, H=12, 3
iLQR iterations, float64 on the CPU, x jitter made with numpy from a seed).

Tolerances: against the JAX package `cost`, `us` and `xs` are held to 1e-7
(the same iterations on the same active sets; the backward sweep multiplies
rounding differences of the LAPACK inverses by the gains). With
`rr_warm_start=False` record/replay is a pure restructuring and equals
`record_replay=False` to 1e-10. The warm-started default drifts from the
cold path at the LCP's termination tolerance: 1e-6 relative on cost, 1e-4 on
us, as in the JAX package's own test.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from moby_tpu.mpc import contact_mpc as jmpc
from moby_tpu_torch.mpc import contact_mpc as tmpc
from moby_tpu_torch.mpc import ilqr as tilqr
from moby_tpu_torch.mpc import MPCOptions
from moby_tpu_torch.solvers import hopper_lcp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import ballpush_both, ballpush_costs, ilqr_arrays

B, H, N_ITERS, DT = 4, 12, 3, 0.02


@pytest.fixture(scope="module")
def task():
    jscene, jstate, jb, tscene, tstate, tb, _ = ballpush_both(B, seed=0)
    jcost, jfinal, tcost, tfinal = ballpush_costs()
    jprob = jmpc.MPCProblem(scene=jscene, template=jstate, dt=DT, horizon=H)
    tprob = tmpc.MPCProblem(scene=tscene, template=tstate, dt=DT, horizon=H)

    def jax_solve(**kw):
        return ilqr_arrays(jmpc.solve_batch(
            jprob, jb, jcost, jfinal, n_iters=N_ITERS, **kw))

    def torch_solve(states=tb, **kw):
        return ilqr_arrays(tmpc.solve_batch(
            tprob, states, tcost, tfinal, n_iters=N_ITERS, device="cpu", **kw))

    return jax_solve, torch_solve, tprob, tb, tcost, tfinal


@pytest.fixture(scope="module")
def torch_plain(task):
    return task[1](record_replay=False)


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, ("us", "xs", "cost")):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what}: {name}")


def test_default_mode_matches_jax(task):
    jax_solve, torch_solve = task[:2]
    want = jax_solve()
    got = torch_solve()
    assert np.isfinite(want[2]).all() and want[2].max() < 10.0
    assert got[0].shape == (B, H, 6) and got[1].shape == (B, H + 1, 13)
    _close(got, want, 1e-7, "record/replay, warm start")


def test_plain_mode_matches_jax(task, torch_plain):
    want = task[0](record_replay=False)
    _close(torch_plain, want, 1e-7, "record_replay=False")
    # the ball is really pushed: the cost fell from the initial rollout's
    x0_cost = 50.0 * ((torch_plain[1][:, 0, 0:2] - np.array([0.4, 0.0])) ** 2).sum(1)
    assert (torch_plain[2] < x0_cost).all()


def test_cold_record_replay_equals_plain(task, torch_plain):
    got = task[1](rr_warm_start=False)
    _close(got, torch_plain, 1e-10, "rr_warm_start=False")


def test_warm_record_replay_drifts_at_solver_tolerance(task, torch_plain):
    us, xs, cost = task[1]()
    np.testing.assert_allclose(cost, torch_plain[2], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(us, torch_plain[0], rtol=1e-4, atol=1e-7)


def test_kernel_route_on_the_cpu_equals_batched_route(task):
    """cascade="accel" on CPU tensors: every block-pivoting pair of the
    cascade goes through `hopper_lcp.bpp_lcp`, whose plain version stands in
    for the kernel. Same solve, same result (1e-9: another elimination for
    the same active sets)."""
    calls = []
    real = hopper_lcp.bpp_lcp

    def spy(*a, **k):
        calls.append(int(a[2].any(dim=1).sum()))
        return real(*a, **k)

    hopper_lcp.bpp_lcp = spy
    try:
        got = task[1](options=MPCOptions(cascade="accel"), rr_warm_start=False)
        got_warm = task[1](options=MPCOptions(cascade="accel"))
    finally:
        hopper_lcp.bpp_lcp = real
    want = task[1](options=MPCOptions(cascade="plain"), rr_warm_start=False)
    _close(got, want, 1e-9, "kernel route")
    want_warm = task[1](options=MPCOptions(cascade="plain"))
    np.testing.assert_allclose(got_warm[2], want_warm[2], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got_warm[0], want_warm[0], rtol=1e-4, atol=1e-6)
    # stage 1, stage 2 and two ladder rungs a solve; only stage 1 has work
    assert len(calls) % 4 == 0 and sum(calls) > 0
    assert sum(calls[1::4]) == sum(calls[2::4]) == sum(calls[3::4]) == 0


def test_float32_solve_improves_every_member(task):
    jscene, jstate, jb, tscene, tstate, tb, _ = ballpush_both(
        B, seed=0, dtype=torch.float32)
    _, _, tcost, tfinal = ballpush_costs()
    prob = tmpc.MPCProblem(scene=tscene, template=tstate, dt=DT, horizon=H)
    res = tmpc.solve_batch(prob, tb, tcost, tfinal, n_iters=N_ITERS, device="cpu")
    assert res.cost.dtype == torch.float32 and torch.isfinite(res.cost).all()
    c0 = tfinal(tmpc.pack(tscene, tb))      # zero controls: the ball stays put
    assert bool((res.cost < c0).all())
    want = task[1]()
    np.testing.assert_allclose(res.cost.numpy(), want[2], rtol=5e-2)


def test_us0_shapes_line_search_steps_and_device_check(task):
    _, torch_solve, tprob, tb, tcost, tfinal = task
    us0 = torch.zeros(B, H, 6, dtype=torch.float64)
    a = torch_solve(us0=us0)
    b = torch_solve(us0=us0[0])
    _close(a, b, 0.0, "us0 broadcast")
    one = torch_solve(options=MPCOptions(line_search_steps=1))
    assert np.isfinite(one[2]).all() and (one[2] >= a[2] - 1e-12).all()
    with pytest.raises((ValueError, RuntimeError)):
        tmpc.solve_batch(tprob, tb, tcost, tfinal, n_iters=1)   # device="cuda"


def test_pd_inverse_routes():
    """float32 takes the signed-pivot Gauss–Jordan, float64 Cholesky + inverse;
    both flag a matrix that is not positive definite."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 5, 5))
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(5)
    M[1] = -M[1]
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        Mt = torch.tensor(M, dtype=dtype)
        inv, ok = tilqr._pd_inverse(Mt)
        assert ok.tolist() == [True, False, True]
        eye = torch.eye(5, dtype=dtype)
        assert float((Mt[0] @ inv[0] - eye).abs().max()) < tol


def test_mpc_import_pulls_in_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "from moby_tpu_torch.mpc import contact_mpc, diffstep, ilqr, MPCOptions\n"
        "from moby_tpu_torch.solvers import difflcp, hopper_lcp\n"
        "bad = [m for m in ('jax', 'jaxlib', 'moby_tpu', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert hopper_lcp._libs is None\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
