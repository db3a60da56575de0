"""PyTorch port: the differentiable contact step (`moby_tpu_torch.mpc.diffstep`
through `contact_mpc.make_dynamics`) and its Jacobians against
`jax.jacrev` of the JAX package's `make_dynamics`, on ball-push states in
and out of contact; float64 on the CPU.

Tolerances: the step's value 1e-10, its Jacobians (A, B) 1e-8 (absolute, on
entries of order 1): straight-line code plus one LAPACK inverse of the
Tikhonov-shifted active block on each side.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.mpc import contact_mpc as jmpc
from moby_tpu_torch.mpc import contact_mpc as tmpc
from moby_tpu_torch.mpc import diffstep as tdstep
from moby_tpu_torch.mpc import ilqr as tilqr
from moby_tpu_torch.mpc import MPCOptions
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import ballpush_both, t2n

DT = 0.02


def _states(B=6, seed=0):
    """Packed states and controls of the ball: resting on the plane and
    pushed (sliding and sticking contact), pressed down, lifted off (no
    contact), spinning."""
    jscene, jstate, jb, tscene, tstate, tb, _ = ballpush_both(B, seed)
    rng = np.random.default_rng(seed)
    x = np.array(jax.vmap(lambda s: jmpc.pack(jscene, s))(jb))
    u = rng.normal(size=(B, 6)) * 2.0
    x[:, 7:10] += rng.normal(size=(B, 3)) * 0.3       # velocity
    x[:, 10:13] += rng.normal(size=(B, 3)) * 0.5      # spin
    u[0] = 0.0
    x[0, 7:13] = 0.0                                   # at rest, no control
    u[1, :3] = [0.5, 0.0, 0.0]                         # sticking push
    x[1, 7:13] = 0.0
    if B > 2:
        u[2, :3] = [30.0, 5.0, -3.0]                   # sliding push
        x[2, 9] = 0.0
        x[3, 2] += 0.2                                 # in the air
        x[3, 9] = 0.5
        x[4, 9] = -1.0                                 # falling onto the plane
    return jscene, jstate, tscene, tstate, x, u


def test_pack_unpack_roundtrip_and_sizes():
    jscene, jstate, tscene, tstate, x, u = _states()
    assert tmpc.n_controls(tscene) == jmpc.n_controls(jscene) == 6
    assert tmpc.state_sizes(tscene) == jmpc.state_sizes(jscene)
    st = tmpc.unpack(tscene, tstate, torch.tensor(x))
    assert st.pos.shape == (x.shape[0], tscene.nb, 3)
    np.testing.assert_array_equal(t2n(tmpc.pack(tscene, st)), x)
    js = jax.vmap(lambda x_: jmpc.unpack(jscene, jstate, x_))(jnp.asarray(x))
    for name in ("pos", "quat", "vel", "omega"):
        np.testing.assert_array_equal(t2n(getattr(st, name)),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_array_equal(
        t2n(tdstep.state_vector(tscene, st))[:, :3], t2n(st.pos[:, 0]))
    assert tdstep.replay_ok(tscene)


@pytest.fixture(scope="module")
def jax_step_and_jacobians():
    jscene, jstate, tscene, tstate, x, u = _states()
    jf = jmpc.make_dynamics(jscene, jstate, DT)

    def both(x_, u_):
        return jf(x_, u_), jax.jacrev(jf, argnums=(0, 1))(x_, u_)

    xj, (Aj, Bj) = jax.jit(jax.vmap(both))(jnp.asarray(x), jnp.asarray(u))
    return tscene, tstate, x, u, np.asarray(xj), np.asarray(Aj), np.asarray(Bj)


@pytest.mark.parametrize("route", ["plain", "accel"])
def test_dstep_and_jacobians_match_jax_jacrev(route, jax_step_and_jacobians):
    tscene, tstate, x, u, xj, Aj, Bj = jax_step_and_jacobians
    tf = tmpc.make_dynamics(tscene, tstate, DT, MPCOptions(cascade=route))
    xt_in, ut_in = torch.tensor(x), torch.tensor(u)
    xt = tf(xt_in, ut_in)
    np.testing.assert_allclose(t2n(xt), np.asarray(xj), rtol=0, atol=1e-10)
    At, Bt = tilqr._jacobians(tf, xt_in, ut_in)
    assert np.isfinite(t2n(At)).all() and np.isfinite(t2n(Bt)).all()
    np.testing.assert_allclose(t2n(At), np.asarray(Aj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t2n(Bt), np.asarray(Bj), rtol=0, atol=1e-8)
    # contact really shapes some of them: the pushed ball's x-velocity row
    # depends on the spin through friction, the flying ball's does not
    assert np.abs(Aj[1:3, 7:9, 10:13]).max() > 1e-3
    assert np.abs(Aj[3, 7:9, 10:13]).max() == 0.0


def test_record_then_replay_is_the_same_step_with_the_same_jacobians():
    jscene, jstate, tscene, tstate, x, u = _states()
    f, f_rec, f_rep = tmpc.make_dynamics_rr(tscene, tstate, DT)
    xt, ut = torch.tensor(x), torch.tensor(u)
    x1 = f(xt, ut)
    x2, z, aux = f_rec(xt, ut, f_rec.aux_init(x.shape[0]))
    x3 = f_rep(xt, ut, z)
    np.testing.assert_array_equal(t2n(x2), t2n(x1))
    np.testing.assert_array_equal(t2n(x3), t2n(x1))
    assert float(z.abs().max()) > 0 and float(z[3].abs().max()) == 0.0
    np.testing.assert_array_equal(t2n(aux[1][:, 0]), t2n(z.abs().amax(dim=1) > 0))
    # the contact half alone, replaying z: the velocity change of the step
    st = tmpc.unpack(tscene, tstate, xt)
    st_pre = tdstep.dstep_pre(tscene, st, DT, torch.cat(
        [ut, torch.zeros(x.shape[0], 6, dtype=ut.dtype)], dim=1))
    dv = tdstep.contact_dv_replay(tscene, st_pre, z)
    np.testing.assert_allclose(t2n(st_pre.vel[:, 0] + dv[:, :3]), t2n(x1[:, 7:10]),
                               rtol=0, atol=1e-14)
    # a two-step rollout is two steps
    u_full = torch.cat([ut, torch.zeros_like(ut)], dim=1)
    last, states = tdstep.rollout(tscene, st, torch.stack([u_full, u_full]), DT)
    assert len(states) == 2
    np.testing.assert_allclose(t2n(tmpc.pack(tscene, last)), t2n(f(x1, ut)),
                               rtol=0, atol=1e-12)
    A1, B1 = tilqr._jacobians(f, xt, ut)
    A3, B3 = tilqr._jacobians(f_rep, xt, ut, z)
    np.testing.assert_allclose(t2n(A3), t2n(A1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2n(B3), t2n(B1), rtol=0, atol=1e-12)


def test_dstep_gradcheck_float64():
    """`torch.autograd.gradcheck` of the live step (finite differences have
    to see z move, which the replay step's primal does not) on a sliding, a
    flying and a falling ball, whose active sets are stable under the
    perturbation: finds an in-place write or a NaN trap on the
    differentiated path, and holds the IFT gradient to the solver itself."""
    jscene, jstate, tscene, tstate, x, u = _states()
    f = tmpc.make_dynamics(tscene, tstate, DT)
    keep = [2, 3, 4]
    # touching exactly at the threshold, a finite difference in the height
    # switches the contact off: press the touching balls 1 mm into the plane
    x[[2, 4], 2] -= 1e-3
    xg = torch.tensor(x[keep], requires_grad=True)
    ug = torch.tensor(u[keep], requires_grad=True)
    assert torch.autograd.gradcheck(f, (xg, ug), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_resting_ball_gradient_is_finite():
    """The NaN traps of the backward pass: zero slip under the viscous term's
    sqrt, a zero-velocity contact frame, the Tikhonov-shifted active block.
    At rest with no control every Jacobian entry is finite."""
    jscene, jstate, tscene, tstate, x, u = _states()
    f = tmpc.make_dynamics(tscene, tstate, DT)
    A, Bm = tilqr._jacobians(f, torch.tensor(x[:1]), torch.tensor(u[:1]))
    assert torch.isfinite(A).all() and torch.isfinite(Bm).all()
    assert float(A.abs().max()) > 0


def test_articulated_branch_raises():
    """The articulated branch of the step used to raise NotImplementedError;
    it is ported now (tests/test_torch_art_mpc.py holds it against the JAX
    package). It runs Featherstone's ABA with the joint forces u[:, 6·nb:],
    and a control vector without those columns raises."""
    from moby_tpu_torch.core import scene as tsc
    from moby_tpu_torch.sim import stepper as tstepper
    from test_torch_helpers import build_limited_pendulum

    scene, st = build_limited_pendulum(tsc).compile(device="cpu")
    st = st.expand(2)
    tau = torch.tensor([[0.0], [2.0]], dtype=torch.float64)
    pre = tdstep.dstep_pre(scene, st, DT, tau)
    q = tstepper.integrate_art_q(scene, st.q_art, st.qd_art, DT)
    qdd = tstepper.articulated_qdd(scene, st.replace(q_art=q), tau)
    np.testing.assert_allclose(t2n(pre.q_art), t2n(q), rtol=0, atol=0)
    np.testing.assert_allclose(t2n(pre.qd_art), t2n(st.qd_art + qdd * DT), rtol=0,
                               atol=1e-15)
    assert float(pre.qd_art[1, 0] - pre.qd_art[0, 0]) > 0     # the torque acts
    with pytest.raises(RuntimeError):
        tdstep.dstep_pre(scene, st, DT, tau[:, :0])
