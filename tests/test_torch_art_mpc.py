"""PyTorch port: the articulated branch of the differentiable MPC step
(`moby_tpu_torch.mpc.diffstep.dstep_pre`/`dstep` with Featherstone's ABA,
`state_vector`, the packed MPC state) and its Jacobians, against the JAX
package, float64 on the CPU.

The scene: the double pendulum of `examples/double_pendulum.py` with its
first joint limited to [0.5, 3.0] (the repo's limited-pendulum tests),
started on the lower limit and moving into it, so the step's LCP (the limit
rows, n=4) has work. Tolerances: values and Jacobians 1e-10 (absolute, on
entries of order 1); the 2-iteration batched solve 1e-9 relative on cost,
controls and states.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.mpc import contact_mpc as jmpc
from moby_tpu.mpc import diffstep as jdstep
from moby_tpu_torch.mpc import contact_mpc as tmpc
from moby_tpu_torch.mpc import diffstep as tdstep
from moby_tpu_torch.mpc import ilqr as tilqr
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (build_limited_double_pendulum, ilqr_arrays, t2n,
                                torch_scene_state)

DT = 0.01
B = 4


@pytest.fixture(scope="module")
def pendulum():
    jscene, jstate = build_limited_double_pendulum(jsc).compile()
    tscene, tstate = torch_scene_state(jscene, jstate)
    rng = np.random.default_rng(0)
    x = np.repeat(np.asarray(jmpc.pack(jscene, jstate))[None], B, axis=0)
    x[:, 1] += rng.normal(size=B) * 0.5          # second joint anywhere
    x[:, 2] = -np.abs(rng.normal(size=B))        # first joint into its stop
    x[:, 3] += rng.normal(size=B)
    x[0, 0] = 0.49                               # past the stop
    x[1, 2] = 0.5                                # leaving the stop
    u = rng.normal(size=(B, 2)) * 3.0
    return jscene, jstate, tscene, tstate, x, u


def test_scene_and_packing(pendulum):
    jscene, jstate, tscene, tstate, x, u = pendulum
    assert (tscene.nb, tscene.nv_art, tscene.nq_art, tscene.n_limits) == (0, 2, 2, 2)
    assert tmpc.n_controls(tscene) == jmpc.n_controls(jscene) == 2
    assert tmpc.state_sizes(tscene) == jmpc.state_sizes(jscene) == (0, 0, 0, 0, 2, 2)
    st = tmpc.unpack(tscene, tstate, torch.tensor(x))
    np.testing.assert_array_equal(t2n(tmpc.pack(tscene, st)), x)
    js = jax.vmap(lambda x_: jmpc.unpack(jscene, jstate, x_))(jnp.asarray(x))
    np.testing.assert_array_equal(t2n(st.q_art), np.asarray(js.q_art))
    np.testing.assert_array_equal(t2n(st.qd_art), np.asarray(js.qd_art))
    sv = jax.vmap(lambda s: jdstep.state_vector(jscene, s))(js)
    np.testing.assert_array_equal(t2n(tdstep.state_vector(tscene, st)), np.asarray(sv))


@pytest.fixture(scope="module")
def jax_reference(pendulum):
    """The JAX package's pre-contact half, step, LCP solution and
    `jax.jacrev` of `make_dynamics` on every state, in one compiled call."""
    jscene, jstate, tscene, tstate, x, u = pendulum
    jf = jmpc.make_dynamics(jscene, jstate, DT)

    def one(x_, u_):
        s = jmpc.unpack(jscene, jstate, x_)
        pre = jdstep.dstep_pre(jscene, s, DT, u_)
        step, z = jdstep.dstep(jscene, s, DT, u_, return_z=True)
        return pre, step, z, jax.jacrev(jf, argnums=(0, 1))(x_, u_)

    pre, step, z, (A, Bm) = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(u))
    return pre, step, np.asarray(z), (np.asarray(A), np.asarray(Bm))


def test_dstep_pre_and_dstep_match_jax(pendulum, jax_reference):
    jscene, jstate, tscene, tstate, x, u = pendulum
    pre_j, step_j, zj, _ = jax_reference
    st = tmpc.unpack(tscene, tstate, torch.tensor(x))
    ut = torch.tensor(u)
    pre_t = tdstep.dstep_pre(tscene, st, DT, ut)
    for name in ("q_art", "qd_art"):
        np.testing.assert_allclose(t2n(getattr(pre_t, name)),
                                   np.asarray(getattr(pre_j, name)), rtol=0, atol=1e-10)
    step_t, zt = tdstep.dstep(tscene, st, DT, ut, return_z=True)
    for name in ("q_art", "qd_art", "zlast", "time"):
        np.testing.assert_allclose(t2n(getattr(step_t, name)),
                                   np.asarray(getattr(step_j, name)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t2n(zt), zj, rtol=0, atol=1e-10)
    # the stop acted: the limit impulse is positive and the first joint no
    # longer moves into it
    assert float(zt.abs().max()) > 1e-3
    assert bool((step_t.qd_art[:, 0] >= -1e-10).all())
    # the torque reaches the joints: without it the step differs
    free = tdstep.dstep_pre(tscene, st, DT, None)
    assert float((free.qd_art - pre_t.qd_art).abs().max()) > 1e-3


def _close(got, want, what):
    for g, w, name in zip(got, want, ("A", "B")):
        g = t2n(g)
        assert g.shape == w.shape and np.isfinite(g).all()
        err = float(np.abs(g - w).max())
        assert err <= 1e-10, f"{what} {name}: {err:.3e}"


def test_jacobians_match_jax_jacrev(pendulum, jax_reference):
    jax_jacobians = jax_reference[3]
    jscene, jstate, tscene, tstate, x, u = pendulum
    xt, ut = torch.tensor(x), torch.tensor(u)
    f, f_rec, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT)
    assert f_rep is not None and tscene.arts
    _, z, _ = f_rec(xt, ut, f_rec.aux_init(B))
    _close(tilqr._jacobians(f, xt, ut), jax_jacobians, "reverse mode, live step")
    _close(tilqr._jacobians(f_rep, xt, ut, z), jax_jacobians, "reverse mode, replay")
    _close(tilqr._jacobians_fwd(f_rep, xt, ut, z), jax_jacobians, "forward mode")
    # the block linearizer's non-analytic u columns (forward mode over u)
    _close(f_rep.jac(xt, ut, z), jax_jacobians, "block linearizer")
    # the stop shapes A: held against it, the first joint's new velocity
    # does not follow its old one
    A = jax_jacobians[0]
    assert np.abs(A[:, 3, :]).max() > 1e-3


def _costs():
    def jcost(x, u):
        return 1e-3 * jnp.sum(u ** 2)

    def jfinal(x):
        return 10.0 * ((x[1] - 1.0) ** 2 + 0.1 * jnp.sum(x[2:] ** 2))

    def tcost(x, u):
        return 1e-3 * (u ** 2).sum(dim=1)

    def tfinal(x):
        return 10.0 * ((x[:, 1] - 1.0) ** 2 + 0.1 * (x[:, 2:] ** 2).sum(dim=1))

    return jcost, jfinal, tcost, tfinal


def test_solve_batch_matches_jax(pendulum):
    jscene, jstate, tscene, tstate, x, u = pendulum
    jcost, jfinal, tcost, tfinal = _costs()
    H, iters = 4, 2
    xs = x[:2]
    jb = jax.vmap(lambda x_: jmpc.unpack(jscene, jstate, x_))(jnp.asarray(xs))
    want = ilqr_arrays(jmpc.solve_batch(jmpc.MPCProblem(jscene, jstate, DT, H), jb,
                                        jcost, jfinal, n_iters=iters))
    tb = tmpc.unpack(tscene, tstate, torch.tensor(xs))
    prob = tmpc.MPCProblem(tscene, tstate, DT, H)
    got = ilqr_arrays(tmpc.solve_batch(prob, tb, tcost, tfinal, n_iters=iters,
                                       device="cpu"))
    for g, w, name in zip(got, want, ("us", "xs", "cost")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max(),
                                   err_msg=name)
    c0 = t2n(tmpc.solve_batch(prob, tb, tcost, tfinal, n_iters=0, device="cpu").cost)
    assert (got[2] < c0).all()               # the second joint was driven
    # every linearization option gives the same solve
    for kw in (dict(hoist_linearization=True), dict(linearize_fwd=True),
               dict(linearize_fwd=True, hoist_linearization=True)):
        other = ilqr_arrays(tmpc.solve_batch(prob, tb, tcost, tfinal, n_iters=iters,
                                             device="cpu", **kw))
        for g, w, name in zip(other, got, ("us", "xs", "cost")):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max(),
                                       err_msg=f"{kw}: {name}")


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_float32_inverse_inertia_is_differentiable(mode):
    """The float32 route of the articulated inverse inertia (`lcp.gj_invert_pd`,
    the card's) under both modes of differentiation: its pivot rows are
    updated in place, which reverse mode must not see. Held in float64
    against the derivative of the inverse, -A⁻¹ dA A⁻¹."""
    import torch.autograd.forward_ad as fwAD
    from moby_tpu_torch.solvers import lcp as tlcp

    rng = np.random.default_rng(5)
    R = rng.normal(size=(3, 5, 5))
    A = torch.tensor(R @ R.transpose(0, 2, 1) + np.eye(5))
    dA = torch.tensor(rng.normal(size=(3, 5, 5)))
    Ai = torch.linalg.inv(A)
    if mode == "reverse":
        Ar = A.clone().requires_grad_(True)
        E, ok = tlcp.gj_invert_pd(Ar)
        (g,) = torch.autograd.grad((E * dA).sum(), Ar)
        want = -(Ai.transpose(1, 2) @ dA @ Ai.transpose(1, 2))
    else:
        with fwAD.dual_level():
            E, ok = tlcp.gj_invert_pd(fwAD.make_dual(A, dA))
            g = fwAD.unpack_dual(E).tangent
        want = -(Ai @ dA @ Ai)
    assert bool(ok.all())
    np.testing.assert_allclose(t2n(g), t2n(want), rtol=0, atol=1e-10)
