"""Pose-slot kinematics: world poses, velocities and generalized-coordinate
Jacobians of every rigid body (counterpart of ``moby_tpu/sim/kinematics.py``,
free bodies; articulated links come with the articulated bodies).

The generalized-velocity vector v_gc (scene.ngc) is laid out as the
reference's eSpatial coordinates: [v; ω] per free body (6 each).
`PoseTable.W` maps v_gc to each pose slot's world spatial velocity
([v at slot origin; ω]).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import scene as sc


class PoseTable(NamedTuple):
    pos: torch.Tensor    # (B, ns, 3) slot origin, world
    quat: torch.Tensor   # (B, ns, 4)
    vel: torch.Tensor    # (B, ns, 3) linear velocity of slot origin, world
    omega: torch.Tensor  # (B, ns, 3)
    W: torch.Tensor      # (ns, 6, ngc): v_gc -> [v; ω] at slot origin (world)


def _free_body_W(scene: sc.Scene, dtype, device):
    """Constant (nb, 6, ngc) jacobian rows of the free bodies: identity
    blocks masked by enabled (disabled bodies have no gc in the reference;
    zero rows keep them immovable). Depends only on static scene structure,
    so it is shared by the batch."""
    def make():
        nb, ngc = scene.nb, scene.ngc
        W0 = np.zeros((nb, 6, ngc))
        enabled = scene.host["slot_enabled"][:nb]
        for b in range(nb):
            if enabled[b]:
                W0[b, :, 6 * b: 6 * b + 6] = np.eye(6)
        return torch.as_tensor(W0, dtype=dtype, device=device)

    return sc.cached(scene, ("free_body_W", str(dtype), str(device)), make)


def compute(scene: sc.Scene, st: sc.State) -> PoseTable:
    if scene.arts:
        raise NotImplementedError("articulated bodies are not ported yet")
    # free bodies only: the state IS the pose table; W is a constant
    return PoseTable(
        pos=st.pos, quat=st.quat, vel=st.vel, omega=st.omega,
        W=_free_body_W(scene, st.pos.dtype, st.pos.device),
    )


def gc_velocity(scene: sc.Scene, st: sc.State):
    """Assemble the generalized velocity vectors, (B, ngc)."""
    B = st.pos.shape[0]
    if not scene.nb:
        return st.pos.new_zeros((B, 0))
    return torch.cat([st.vel, st.omega], dim=-1).reshape(B, -1)


def apply_gc_velocity_delta(scene: sc.Scene, st: sc.State, dv):
    """Scatter a gc-velocity delta (B, ngc) back into the state."""
    nb = scene.nb
    if nb:
        dvb = dv[:, : 6 * nb].reshape(-1, nb, 6)
        st = st.replace(vel=st.vel + dvb[..., :3], omega=st.omega + dvb[..., 3:])
    return st
