"""PyTorch port: `moby_tpu_torch.sim.impact` and `sim.stabilization` against
the JAX package, float64. `assemble_problem` and `build_qp_lcp` are
straight-line code: 1e-10. `resolve_impacts` and `stabilize` go through the
pivoting cascade: 1e-9."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.geometry import narrowphase as jnph
from moby_tpu.sim import impact as jimp
from moby_tpu.sim import kinematics as jkin
from moby_tpu.sim import stabilization as jstab
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.geometry import narrowphase as tnph
from moby_tpu_torch.sim import impact as timp
from moby_tpu_torch.sim import kinematics as tkin
from moby_tpu_torch.sim import stabilization as tstab
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    build_ballpush, build_box_on_plane, build_stack, jax_fields, t2n,
    torch_scene_state,
)

B = 4
SCENES = {
    "stack_nk4": lambda sc: build_stack(sc, nk=4),
    "stack_nk16": lambda sc: build_stack(sc, nk=16),
    "ballpush_eps0": build_ballpush,
    "box_on_plane": build_box_on_plane,
}


def _states(name, seed, sink=0.0):
    """Touching bodies with random velocities (downward on average), so that
    contacts are active and impacting in most members."""
    jscene, jstate = SCENES[name](jsc).compile()
    tscene, _ = torch_scene_state(jscene, jstate)
    rng = np.random.default_rng(seed)
    nb = jscene.nb
    pos = np.broadcast_to(np.asarray(jstate.pos), (B, nb, 3)).copy()
    pos[:, :-1, 2] -= sink * rng.uniform(0.2, 1.0, size=(B, nb - 1))
    vel = rng.normal(size=(B, nb, 3)) * 0.3
    vel[:, :, 2] -= 0.5
    omega = rng.normal(size=(B, nb, 3)) * 0.3
    vel[-1] = 0.0                          # one member at rest: no impact
    omega[-1] = 0.0
    vel[:, -1] = 0.0
    omega[:, -1] = 0.0
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jstate).replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), omega=jnp.asarray(omega))
    tst = tsc.state_from_arrays(jax_fields(jst), "cpu", torch.float64)
    return jscene, tscene, jst, tst


def _jax_contacts(jscene, s, tol):
    pt = jkin.compute(jscene, s)
    _, con = jnph.narrow_phase(jscene, pt.pos, pt.quat, jnp.asarray(tol))
    return pt, con


@pytest.mark.parametrize("name", list(SCENES))
def test_assemble_and_build_qp_lcp_match_jax(name):
    jscene, tscene, jst, tst = _states(name, 1)
    nz = 1.5e-8

    def jfun(s):
        pt, con = _jax_contacts(jscene, s, 1e-6)
        act, act_lim, cn_vel, _ = jimp._active(jscene, s, pt, con, nz)
        p = jimp.assemble_problem(jscene, s, pt, con, act, act_lim)
        MM, qq, mask = jimp.build_qp_lcp(jscene, p, act, act_lim)
        return act, cn_vel, p.Jall, p.A, p.bv, p.Minv, MM, qq, mask

    outs_j = jax.vmap(jfun)(jst)
    ptt = tkin.compute(tscene, tst)
    _, cont = tnph.narrow_phase(tscene, ptt.pos, ptt.quat, 1e-6)
    act, act_lim, cn_vel, _ = timp._active(tscene, tst, ptt, cont, nz)
    p = timp.assemble_problem(tscene, tst, ptt, cont, act, act_lim)
    MM, qq, mask = timp.build_qp_lcp(tscene, p, act, act_lim)
    outs_t = (act, cn_vel, p.Jall, p.A, p.bv, p.Minv, MM, qq, mask)
    assert t2n(act).any() and not t2n(act)[-1].any()
    for t_, j_, nm in zip(outs_t, outs_j,
                          "act cn_vel Jall A bv Minv MM qq mask".split()):
        if t_.dtype == torch.bool:
            np.testing.assert_array_equal(t2n(t_), np.asarray(j_), err_msg=nm)
        else:
            np.testing.assert_allclose(t2n(t_), np.asarray(j_), atol=1e-10,
                                       rtol=0, err_msg=nm)
    assert MM.shape == (B, jscene.n_lcp, jscene.n_lcp)
    # the dense route gives the same Delassus operator
    A_dense = (p.Jall @ p.Minv) @ p.Jall.transpose(-1, -2)
    np.testing.assert_allclose(t2n(A_dense), t2n(p.A), atol=1e-10, rtol=0)
    cn, cs, ct, l = timp.unstack_impulses(tscene, qq)
    np.testing.assert_allclose(
        t2n(timp.impulse_dv(tscene, p, cn, cs, ct, l)),
        np.asarray(jax.vmap(lambda s, z: (lambda pt_con: jimp.impulse_dv(
            jscene, jimp.assemble_problem(
                jscene, s, pt_con[0], pt_con[1],
                *jimp._active(jscene, s, pt_con[0], pt_con[1], nz)[:2]),
            *jimp.unstack_impulses(jscene, z)))(_jax_contacts(jscene, s, 1e-6))
        )(jst, outs_j[7])), atol=1e-10, rtol=0)


def test_contact_rows_match_jax():
    """`_contact_rows` along the contact normals is the Jn block of the
    assembled problem, in both packages (straight-line code: 1e-10)."""
    jscene, tscene, jst, tst = _states("stack_nk4", 5)

    def jfun(s):
        pt, con = _jax_contacts(jscene, s, 1e-6)
        return jimp._contact_rows(jscene, pt, con, con.active, con.normal)

    ptt = tkin.compute(tscene, tst)
    _, cont = tnph.narrow_phase(tscene, ptt.pos, ptt.quat, 1e-6)
    rows = timp._contact_rows(tscene, ptt, cont, cont.active, cont.normal)
    assert rows.shape == (B, jscene.n_contacts, jscene.ngc)
    assert np.abs(t2n(rows)).max() > 0.5
    np.testing.assert_allclose(t2n(rows), np.asarray(jax.vmap(jfun)(jst)),
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("cascade", ["plain", "accel"])
@pytest.mark.parametrize("name", list(SCENES))
def test_resolve_impacts_matches_jax(name, cascade):
    """Both branches: eps == 0 everywhere (ball-push) and the restitution
    re-solve (the others). The port's accelerated cascade (plain PPM standing
    in for the kernel) must give the same impulses as the plain one."""
    jscene, tscene, jst, tst = _states(name, 2)

    def jfun(s):
        pt, con = _jax_contacts(jscene, s, 1e-6)
        r = jimp.resolve_impacts(jscene, s, pt, con, s.zlast, s.zlast_active)
        return r.dv, r.zlast, r.zlast_active, r.impulses_n, r.z_step

    rj = jax.vmap(jfun)(jst)
    ptt = tkin.compute(tscene, tst)
    _, cont = tnph.narrow_phase(tscene, ptt.pos, ptt.quat, 1e-6)
    r = timp.resolve_impacts(tscene, tst, ptt, cont, tst.zlast, tst.zlast_active,
                             cascade=cascade)
    rt = (r.dv, r.zlast, r.zlast_active, r.impulses_n, r.z_step)
    assert np.abs(t2n(r.dv)[:-1]).max() > 1e-3 and np.all(t2n(r.dv)[-1] == 0)
    tol = 1e-9 if name != "box_on_plane" else 1e-7   # redundant contacts: z is
    for t_, j_, nm in zip(rt, rj, "dv zlast zlast_active impulses_n z_step".split()):
        if t_.dtype == torch.bool:                   # not unique, dv is
            np.testing.assert_array_equal(t2n(t_), np.asarray(j_), err_msg=nm)
        elif name != "box_on_plane" or nm == "dv":
            np.testing.assert_allclose(t2n(t_), np.asarray(j_), atol=tol, rtol=0,
                                       err_msg=nm)
    assert r.pivots.dtype == torch.int32 and r.pivots.shape == (B,)


@pytest.mark.parametrize("name", ["stack_nk4", "box_on_plane"])
def test_stabilize_matches_jax(name):
    jscene, tscene, jst, tst = _states(name, 3, sink=2e-3)
    sj = jax.vmap(lambda s: jstab.stabilize(jscene, s))(jst)
    stt = tstab.stabilize(tscene, tst)
    moved = np.abs(np.asarray(sj.pos) - np.asarray(jst.pos)).max()
    assert moved > 1e-4                      # the projection really ran
    np.testing.assert_allclose(t2n(stt.pos), np.asarray(sj.pos), atol=1e-9, rtol=0)
    np.testing.assert_allclose(t2n(stt.quat), np.asarray(sj.quat), atol=1e-9, rtol=0)
    np.testing.assert_array_equal(t2n(stt.vel), np.asarray(sj.vel))
