"""Block-push (`examples/block_push_mpc.py`) solved by one package in one
dtype on the CPU, and its controls re-evaluated by a float64 rollout of the
same package: the final cost the solve reports, the float64 cost of its
controls, and the final xy.

The two packages give the same float32/float64 gap: the block rests on four
coplanar contacts, so the active block of the step's LCP is singular and its
IFT derivative is set by the Tikhonov shift sqrt(eps)·‖M‖∞, which differs by
dtype. Each process imports one package only:

    python scripts/block_push_dtype_gap.py --package torch --dtype float32
    python scripts/block_push_dtype_gap.py --package jax --dtype float32
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H, DT, ITERS, TARGET = 30, 0.02, 12, (0.6, 0.3)


def run_torch(dtype, iters):
    import torch
    from moby_tpu_torch.core import scene as sc
    from moby_tpu_torch.math import quaternion as quat
    from moby_tpu_torch.mpc import contact_mpc

    torch.set_num_threads(4)

    def build(dt):
        b = sc.SceneBuilder()
        b.set_gravity([0, 0, -9.81])
        b.add_body("block", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
                   pos=np.array([0.0, 0.0, 0.2]))
        b.add_geom("block", sc.BOX, [0.2, 0.2, 0.2])
        b.add_body("ground", enabled=False)
        pq = quat.from_rpy(torch.tensor([1.5707963267949, 0, 0], dtype=torch.float64))
        b.add_geom("ground", sc.PLANE, [0.0], quat=pq.numpy())
        b.set_contact_params("ground", "block", sc.ContactParams(mu_coulomb=0.3, nk=4))
        scene, st = b.compile(device="cpu", dtype=dt)
        return contact_mpc.MPCProblem(scene=scene, template=st, dt=DT, horizon=H), st

    def cost(x, u):
        return 1e-4 * (u[:, :6] ** 2).sum(dim=1)

    def cost_final(x):
        t = torch.tensor(TARGET, dtype=x.dtype)
        return 100.0 * ((x[:, 0:2] - t) ** 2).sum(dim=1)

    prob, st = build(getattr(torch, dtype))
    res = contact_mpc.solve(prob, st, cost, cost_final, n_iters=iters, device="cpu")
    prob64, st64 = build(torch.float64)
    f = contact_mpc.make_dynamics(prob64.scene, prob64.template, DT)
    x = contact_mpc.pack(prob64.scene, st64)
    us = res.us.to(torch.float64)
    c64 = 0.0
    with torch.no_grad():
        for t in range(H):
            c64 += float(cost(x, us[t][None])[0])
            x = f(x, us[t][None])
    c64 += float(cost_final(x)[0])
    return float(res.cost), c64, [float(v) for v in res.xs[-1, :2]]


def run_jax(dtype, iters):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from moby_tpu.core import scene as sc
    from moby_tpu.math import quaternion as quat
    from moby_tpu.mpc import contact_mpc

    def build(dt):
        b = sc.SceneBuilder(dtype=dt)
        b.set_gravity([0, 0, -9.81])
        b.add_body("block", mass=1.0, inertia=sc.box_inertia(1.0, 0.2, 0.2, 0.2),
                   pos=np.array([0.0, 0.0, 0.2]))
        b.add_geom("block", sc.BOX, [0.2, 0.2, 0.2])
        b.add_body("ground", enabled=False)
        pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
        b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
        b.set_contact_params("ground", "block", sc.ContactParams(mu_coulomb=0.3, nk=4))
        scene, st = b.compile()
        return contact_mpc.MPCProblem(scene=scene, template=st, dt=DT, horizon=H), st

    target = jnp.array(TARGET)

    def cost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def cost_final(x):
        return 100.0 * jnp.sum((x[0:2] - target.astype(x.dtype)) ** 2)

    prob, st = build(getattr(jnp, dtype))
    res = contact_mpc.solve(prob, st, cost, cost_final, n_iters=iters)
    prob64, st64 = build(jnp.float64)
    f = contact_mpc.make_dynamics(prob64.scene, prob64.template, DT)
    x = contact_mpc.pack(prob64.scene, st64)
    us = np.asarray(res.us, dtype=np.float64)
    c64 = 0.0
    for t in range(H):
        c64 += float(cost(x, us[t]))
        x = f(x, jnp.asarray(us[t]))
    c64 += float(cost_final(x))
    return float(res.cost), c64, [float(v) for v in np.asarray(res.xs[-1, :2])]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--dtype", choices=("float32", "float64"), required=True)
    ap.add_argument("--iters", type=int, default=ITERS)
    a = ap.parse_args()
    t0 = time.time()
    run = run_torch if a.package == "torch" else run_jax
    cost, cost64, xy = run(a.dtype, a.iters)
    print(json.dumps({"package": a.package, "dtype": a.dtype, "iters": a.iters,
                      "cost": cost, "cost_of_its_controls_in_float64": cost64,
                      "final_xy": xy, "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
