"""Spatial (6-D) vector helpers; the part of ``moby_tpu/math/spatial.py``
that the free-body contact step uses.

At the generalized-coordinate boundary (contact Jacobians, generalized
velocities exposed to the solvers) the layout is the reference's
``[linear; angular]``; Featherstone's is ``[ω; v]``. The articulated-body
algebra of the JAX module (Plücker transforms, cross-product matrices,
spatial inertia) comes with the articulated bodies.
"""

from __future__ import annotations

import torch


def to_moby_gc(v6):
    """[ω; v] (Featherstone) -> [v; ω] (reference generalized-coordinate
    layout)."""
    return torch.cat([v6[..., 3:], v6[..., :3]], dim=-1)


def from_moby_gc(v6):
    """[v; ω] -> [ω; v]."""
    return torch.cat([v6[..., 3:], v6[..., :3]], dim=-1)
