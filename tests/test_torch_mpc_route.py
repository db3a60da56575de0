"""PyTorch port: the kernel route of the contact-MPC cascade
(`difflcp._mpc_forward` with `MPCOptions(cascade="accel")`, where
`hopper_lcp.bpp_lcp`'s plain version stands in for the kernel on the CPU)
checks every stage at the tolerance of M, as the JAX package's `_mpc_xla`
does, and a NaN in M fails the check instead of passing as "trivial".

`bpp_lcp_plain(check_tol=t)` gives the `ok` of the batched `lcp_bpp` +
`_verify(t)` pair it stands for; the cascade equals `_mpc_xla` in float64:
z to 1e-10·max(1, ‖z‖∞), and NaN with ok False on a member with a NaN in M.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moby_tpu.solvers import difflcp as jdiff
from moby_tpu_torch.solvers import difflcp as tdiff
from moby_tpu_torch.solvers import hopper_lcp
from moby_tpu_torch.solvers import lcp as tlcp
from moby_tpu_torch.solvers.difflcp import MPCOptions
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_kkt, make_monotone, t2n


def _residual(M, q, z, mask):
    """How far z is from passing `_verify`: the least tolerance it needs."""
    zm = torch.where(mask, z, 0.0)
    w = torch.where(mask, (M @ zm[..., None])[..., 0] + q, 0.0)
    return torch.stack([(-zm).amax(dim=1), (-w).amax(dim=1),
                        (zm * w).abs().amax(dim=1)]).amax(dim=0).clamp_min(0.0)


def _pair_ok(M, q, mask, tol, z0=None):
    Mp, qp = tlcp.pad_lcp(M, q, mask)
    z, ok = tlcp.lcp_bpp(M, q, mask, z0=z0, max_iters=12)
    return z, ok & tlcp._verify(Mp, qp, z, mask, tol)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_plain_check_tol_agrees_with_batched_bpp_and_verify(warm):
    """Monotone, KKT-shaped and partially masked problems, and problems whose
    start set is empty because every q_i lies in (-ztol, 0): there z = 0 and
    w = q, so the check needs exactly t >= max(-q). t sweeps across each
    problem's residual (a tenth of it, ten times it), is NaN, or is large."""
    B, n = 8, 10
    M, q = make_monotone(B, n, 31)
    Mk, qk = make_kkt(2, 7, 3, 31)
    M[4:6], q[4:6] = Mk, qk
    mask = np.ones((B, n), bool)
    mask[1, 6:] = False
    rng = np.random.default_rng(31)
    # empty start sets: ztol = m·‖M‖∞·eps, q_i in (-ztol/4, 0)
    for b in (6, 7):
        ztol = n * np.abs(M[b]).sum(axis=1).max() * np.finfo(np.float64).eps
        q[b] = -rng.uniform(0.01, 0.25, size=n) * ztol
    Mt, qt, mt = torch.tensor(M), torch.tensor(q), torch.tensor(mask)
    z0 = None
    if warm:
        zc, _ = hopper_lcp.bpp_lcp_plain(Mt, qt, mt)
        z0 = zc * torch.tensor(rng.uniform(0.5, 1.5, size=(B, n)))
    zp, _ = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, z0=z0, check_tol=torch.ones(B))
    zb, _ = _pair_ok(Mt, qt, mt, torch.ones(B), z0)
    Mp, qp = tlcp.pad_lcp(Mt, qt, mt)
    r = torch.stack([_residual(Mp, qp, zp, mt), _residual(Mp, qp, zb, mt)])
    assert bool((r[:, 6:] > 0).all())          # w = q < 0 there: a real residual
    lo, hi = r.amin(dim=0) / 10, r.amax(dim=0) * 10
    sweep = {"below": lo, "above": hi, "nan": torch.full((B,), torch.nan),
             "large": torch.full((B,), 1e-6)}
    for name, t in sweep.items():
        _, okp = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, z0=z0, check_tol=t)
        _, okb = _pair_ok(Mt, qt, mt, t, z0)
        np.testing.assert_array_equal(t2n(okp), t2n(okb), err_msg=name)
        if name in ("above", "large"):
            assert t2n(okp).all(), name
        if name == "nan":
            assert not t2n(okp).any()
        if name == "below":
            assert not t2n(okp)[r.amin(dim=0) > 0].any()
    # the empty-start-set problems are checked, and only with check_tol
    _, ok_auto = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, z0=z0)
    _, ok_low = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, z0=z0, check_tol=lo)
    assert t2n(ok_auto)[6:].all() and not t2n(ok_low)[6:].any()


def test_plain_check_tol_nan_in_m_and_empty_mask():
    """A NaN in M empties the start set (every tolerance is NaN): without
    `check_tol` that is 'trivial', ok=1; with it, z = 0 is checked, w = M·0 +
    q is NaN and ok=0, as `_verify` says. An all-false mask is ok=1 with any
    `check_tol`, NaN included."""
    B, n = 3, 6
    M, q = make_monotone(B, n, 6)
    M[0, 1, 3] = np.nan
    mask = np.ones((B, n), bool)
    mask[2] = False
    Mt, qt, mt = torch.tensor(M), torch.tensor(q), torch.tensor(mask)
    Mp, qp = tlcp.pad_lcp(Mt, qt, mt)
    tol = tlcp._check_tol(Mp, mt)
    _, ok = hopper_lcp.bpp_lcp_plain(Mt, qt, mt)
    assert t2n(ok).tolist() == [True, True, True]
    for t in (tol, torch.full((B,), torch.nan)):
        _, ok = hopper_lcp.bpp_lcp_plain(Mt, qt, mt, check_tol=t)
        _, okb = _pair_ok(Mt, qt, mt, t)
        assert t2n(ok).tolist() == [False, bool(torch.isfinite(t[1])), True]
        np.testing.assert_array_equal(t2n(ok)[:2], t2n(okb)[:2])


def _jax_cascade(M, q, mask, z0, skip):
    return jax.vmap(jdiff._mpc_xla)(
        jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask), jnp.asarray(z0),
        jnp.asarray(skip))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_kernel_route_matches_mpc_xla_with_nan_member(warm):
    """The kernel route (plain version in the kernel's place) against
    `_mpc_xla`, float64: a member with a NaN in M comes back NaN with ok
    False in both (the kernel route used to accept z = 0 at stage 1), the
    finite members agree to 1e-10."""
    B, n = 6, 8
    M, q = make_monotone(B, n, 41)
    Mk, qk = make_kkt(2, 6, 2, 41)
    M[3:5], q[3:5] = Mk, qk
    M[2, 1, 5] = np.nan
    mask = np.ones((B, n), bool)
    mask[1, 6:] = False
    skip = np.zeros(B, bool)
    z0 = np.zeros((B, n))
    if warm:
        zc, _ = _jax_cascade(M, q, mask, z0, skip)
        z0 = np.nan_to_num(np.asarray(zc)) * np.random.default_rng(4).uniform(
            0.5, 1.5, size=(B, n))
    zj, okj = _jax_cascade(M, q, mask, z0, skip)
    zj, okj = np.asarray(zj), np.asarray(okj)
    zt, okt = tdiff._mpc_forward(
        torch.tensor(M), torch.tensor(q), torch.tensor(mask), torch.tensor(z0),
        torch.tensor(skip), MPCOptions(cascade="accel"))
    zt, okt = t2n(zt), t2n(okt)
    np.testing.assert_array_equal(okt, okj)
    assert not okt[2] and okt[[0, 1, 3, 4, 5]].all()
    assert np.isnan(zt[2]).all() and np.isnan(zj[2]).all()
    fin = np.isfinite(zj)
    np.testing.assert_array_equal(np.isfinite(zt), fin)
    np.testing.assert_allclose(zt[fin], zj[fin], rtol=0,
                               atol=1e-10 * max(1.0, np.abs(zj[fin]).max()))


def test_kernel_route_checks_every_stage_at_the_tolerance_of_m():
    """Every `bpp_lcp` call of the cascade (stage 1, stage 2 and the ladder,
    on M + λI) is given `check_tol` = m·‖M‖∞·sqrt(eps) of M itself."""
    B, n = 3, 6
    M, q = make_monotone(B, n, 9)
    M[1] = 0.0                    # singular: stage 1 fails, the rest run
    M[1, :2, :2] = 1.0
    M[1, 2, 2] = 1.0
    q[1] = [-1.0, -0.5, 1.0, 0.0, 1.0, 1.0]
    Mt, qt = torch.tensor(M), torch.tensor(q)
    mt = torch.ones(B, n, dtype=torch.bool)
    want = tlcp._check_tol(*tlcp.pad_lcp(Mt, qt, mt)[:1], mt)
    seen = []
    real = hopper_lcp.bpp_lcp

    def spy(*a, **k):
        seen.append(k["check_tol"])
        return real(*a, **k)

    with mock.patch.object(hopper_lcp, "bpp_lcp", spy):
        _, ok = tdiff._mpc_forward(Mt, qt, mt, None, None,
                                   MPCOptions(cascade="accel"))
    assert len(seen) == 4 and bool(ok.all())
    for t in seen:
        np.testing.assert_array_equal(t2n(t), t2n(want))
