"""Mesh loading and mass properties (counterpart of the loading and
mass-property part of ``moby_tpu/geometry/trimesh.py``; numpy only).

`load_obj` reads the OBJ of a ``<Polyhedron>``; `mesh_inertia` gives its
inertia from the divergence-theorem integrals of the reference's
`TessellatedPolyhedron::calc_volume_ints`. The triangle-mesh contact
functions of the JAX module are not ported yet.
"""

from __future__ import annotations

import numpy as np


def load_obj(path):
    """Load a Wavefront OBJ as an indexed triangle mesh.

    Returns (verts (V, 3) float64, faces (F, 3) int32). Polygon faces are
    fan-triangulated. (The reference reads meshes through
    `IndexedTriArray::read_from_obj`, src/IndexedTriArray.cpp.)
    """
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def mesh_mass_properties(verts, faces, density=1.0):
    """Volume, center of mass, and inertia tensor (about the COM, in the
    mesh frame) of a watertight outward-oriented triangle mesh.

    Divergence-theorem tetrahedron decomposition against the origin (the
    integrals of `TessellatedPolyhedron::calc_volume_ints`, reference
    src/TessellatedPolyhedron.cpp). Returns
    (volume, com (3,), J (3,3) about com, mass) at the given density.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    # signed tetra volumes against the origin
    cr = np.cross(b, c)
    vol6 = np.einsum("ij,ij->i", a, cr)   # 6 * signed volume
    volume = vol6.sum() / 6.0
    # integral of x over the tet (0, a, b, c) = vol6/24 * (a + b + c)
    com = ((a + b + c) * vol6[:, None] / 24.0).sum(axis=0) / max(volume, 1e-300)

    # second moments: sum over tets of (vol6/120) * (PᵀP + s sᵀ), P's rows
    # a, b, c and s their sum
    C = np.zeros((3, 3))
    for i in range(len(a)):
        P = np.stack([a[i], b[i], c[i]])
        s = P.sum(axis=0)
        C += (P.T @ P + np.outer(s, s)) * (vol6[i] / 120.0)
    # shift to COM
    C -= volume * np.outer(com, com)
    J = np.eye(3) * np.trace(C) - C
    mass = density * volume
    return volume, com, density * J, mass


def mesh_inertia(mass, verts, faces):
    """(3, 3) inertia about the COM scaled to the given total mass, the COM
    and the volume."""
    volume, com, J_unit, _ = mesh_mass_properties(verts, faces, density=1.0)
    if volume <= 0:
        raise ValueError("mesh has non-positive volume (check orientation)")
    return J_unit * (mass / volume), com, volume
