"""PyTorch port: `moby_tpu_torch.config` and `moby_tpu_torch.math` against
the JAX package on seeded numpy inputs, float64: straight-line code, 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moby_tpu import config as jcfg
from moby_tpu.math import linalg as jlin
from moby_tpu.math import quaternion as jq
from moby_tpu.math import so3 as jso3
from moby_tpu.math import spatial as jsp
from moby_tpu_torch import config as tcfg
from moby_tpu_torch.math import linalg as tlin
from moby_tpu_torch.math import quaternion as tq
from moby_tpu_torch.math import so3 as tso3
from moby_tpu_torch.math import spatial as tsp
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import make_monotone, t2n

ATOL = 1e-12


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _unit_quats(n, seed):
    q = _rand((n, 4), seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _cmp(t, j, atol=ATOL):
    np.testing.assert_allclose(t2n(t), np.asarray(j), atol=atol, rtol=0)


def test_config():
    assert tcfg.near_zero(torch.float64) == jcfg.near_zero(np.float64)
    assert tcfg.near_zero(torch.float32) == jcfg.near_zero(np.float32)
    assert tcfg.near_zero(np.float32) == jcfg.NEAR_ZERO_F32
    assert tcfg.default_dtype("cpu") == torch.float64
    assert tcfg.default_dtype("cuda") == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcfg.resolve_device("cuda")


@pytest.mark.parametrize("name", ["mul", "rotate", "inverse_rotate", "deriv"])
def test_quaternion_binary(name):
    q = _unit_quats(9, 1)
    other = _unit_quats(9, 2) if name == "mul" else _rand((9, 3), 2)
    _cmp(getattr(tq, name)(torch.tensor(q), torch.tensor(other)),
         getattr(jq, name)(jnp.asarray(q), jnp.asarray(other)))


@pytest.mark.parametrize("name", ["conj", "normalize", "to_matrix"])
def test_quaternion_unary(name):
    q = _rand((9, 4), 3)
    _cmp(getattr(tq, name)(torch.tensor(q)), getattr(jq, name)(jnp.asarray(q)))


def test_quaternion_from_matrix_all_branches():
    # rotations near identity, near 180 degrees about each axis, and random:
    # every one of Shepperd's four candidates is selected somewhere
    q = np.concatenate([
        _unit_quats(8, 4),
        np.eye(4)[[0, 1, 2, 3]] + 1e-3 * _rand((4, 4), 5),
    ])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jq.to_matrix(jnp.asarray(q)))
    _cmp(tq.from_matrix(torch.tensor(R)), jq.from_matrix(jnp.asarray(R)))
    back = t2n(tq.from_matrix(torch.tensor(R)))
    np.testing.assert_allclose(np.abs(np.sum(back * q, axis=-1)), 1.0, atol=1e-12)


def test_quaternion_constructors():
    rpy = _rand((5, 3), 6)
    _cmp(tq.from_rpy(torch.tensor(rpy)), jq.from_rpy(jnp.asarray(rpy)))
    axis = _rand((5, 3), 7)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = _rand((5,), 8)
    _cmp(tq.from_axis_angle(torch.tensor(axis), torch.tensor(ang)),
         jq.from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)))
    _cmp(tq.identity(torch.float64), jq.identity(jnp.float64))


def test_so3():
    v = _rand((7, 3), 9)
    _cmp(tso3.hat(torch.tensor(v)), jso3.hat(jnp.asarray(v)))
    _cmp(tso3.rpy_to_matrix(torch.tensor(v)), jso3.rpy_to_matrix(jnp.asarray(v)))
    n = np.concatenate([v, np.eye(3), -np.eye(3)])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1, t2 = tso3.orthonormal_basis(torch.tensor(n))
    j1, j2 = jso3.orthonormal_basis(jnp.asarray(n))
    _cmp(t1, j1)
    _cmp(t2, j2)


def test_spatial_gc_layout():
    v = _rand((4, 6), 10)
    _cmp(tsp.to_moby_gc(torch.tensor(v)), jsp.to_moby_gc(jnp.asarray(v)))
    _cmp(tsp.from_moby_gc(torch.tensor(v)), jsp.from_moby_gc(jnp.asarray(v)))


def test_linalg_masked():
    M, q = make_monotone(1, 9, 11)
    M, q = M[0], q[0]
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], bool)
    xt, okt = tlin.masked_solve(torch.tensor(M), torch.tensor(q), torch.tensor(mask))
    xj, okj = jlin.masked_solve(jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask))
    _cmp(xt, xj, 1e-10)
    assert bool(okt) == bool(okj) is True
    _cmp(tlin.solve_spd_masked(torch.tensor(M), torch.tensor(q), torch.tensor(mask)),
         jlin.solve_spd_masked(jnp.asarray(M), jnp.asarray(q), jnp.asarray(mask)), 1e-10)
    _cmp(tlin.solve_spd(torch.tensor(M), torch.tensor(q)),
         jlin.solve_spd(jnp.asarray(M), jnp.asarray(q)), 1e-10)
    assert bool(tlin.cholesky_ok(torch.tensor(M), torch.tensor(mask))) == bool(
        jlin.cholesky_ok(jnp.asarray(M), jnp.asarray(mask))) is True
    bad = M - 50.0 * np.eye(9)
    assert bool(tlin.cholesky_ok(torch.tensor(bad))) == bool(
        jlin.cholesky_ok(jnp.asarray(bad))) is False
