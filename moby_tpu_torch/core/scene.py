"""Scene compilation: a Moby-style scene -> static fixed-shape tensors
(counterpart of ``moby_tpu/core/scene.py``).

The scene is compiled host-side (numpy) into a frozen :class:`Scene` of
fixed-shape tensors shared by every scenario of a batch:

* rigid bodies and articulated-body links -> "pose slots" (free body i =
  slot i; link l of articulated body k = slot nb + link offset),
* generalized coordinates -> one gc vector: 6 per free body ([v; ω], the
  reference's eSpatial layout) followed by each articulated body's nv joint
  velocities,
* collision geometries -> typed parameter table with local poses folded in,
* candidate pairs -> a static pair table grouped by narrow-phase kind,
* contact slots -> fixed-K layout with per-slot static contact parameters,
* joint limits -> fixed slots (2 per limited dof: upper and lower), active
  when q crosses the limit (ArticulatedBody::find_limit_constraints),
* friction-cone rows -> a static (contact, cos θ, sin θ) table mirroring
  `setup_QP`'s NK/2 half-plane rows (src/ImpactConstraintHandlerQP.cpp:456-479).

:class:`State` carries the batch: every field has a leading ``B``.

The port covers free bodies and articulated bodies with SPHERE, PLANE, BOX,
CYLINDER, CONE, TORUS, POLYHEDRON (convex vertex cloud) and TRIMESH
(triangle mesh) geometry in the narrow-phase kinds 0-6 and 9-13, joint
limits, bilateral (gear, point and planar) constraints and compliant bodies.
Pair pooling, heightmaps, the support-function pairs (kinds >= 100, e.g.
cylinder-sphere, and a mesh against a curved solid, kinds >= 400) and plugin
kernels are accepted by `SceneBuilder`'s methods and refused by
``compile()`` with a ``NotImplementedError`` that names the pair or the
feature. The convex hulls of BOX and POLYHEDRON geometry are computed at
compile by the repo's native quickhull (`geometry.hull`); a POLYHEDRON's
hull triangles let it meet a mesh through the mesh-mesh kind. The heightmap
grid tables of the JAX ``Scene`` (``hm_heights``, ``hm_size``) have no
consumer yet and are not carried.

Index tables are int64 (PyTorch's indexing type) where the JAX package uses
int32; values are equal.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import config as cfg
from ..dynamics import model as amdl

# geometry type codes
SPHERE = 0
PLANE = 1
BOX = 2
CYLINDER = 3
CONE = 4
TORUS = 5
HEIGHTMAP = 6
POLYHEDRON = 7
NONE = 8
TRIMESH = 9

_GEOM_NAMES = {
    SPHERE: "SPHERE", PLANE: "PLANE", BOX: "BOX", CYLINDER: "CYLINDER",
    CONE: "CONE", TORUS: "TORUS", HEIGHTMAP: "HEIGHTMAP",
    POLYHEDRON: "POLYHEDRON", NONE: "NONE", TRIMESH: "TRIMESH",
}
_PORTED_GEOMS = frozenset({SPHERE, PLANE, BOX, CYLINDER, CONE, TORUS, POLYHEDRON,
                           TRIMESH})

# narrow-phase kind codes (mirrors CCD::find_contacts dispatch,
# include/Moby/CCD.inl:3-81); same values as the JAX package
K_SPHERE_SPHERE = 0   # A=sphere, B=sphere, 1 slot
K_SPHERE_PLANE = 1    # A=sphere, B=plane, 1 slot
K_BOX_SPHERE = 2      # A=box, B=sphere, 1 slot
K_PLANE_GENERIC = 3   # A=plane, B=vertex-carrying solid, vmax slots
K_CYLINDER_PLANE = 4  # A=cylinder, B=plane, 4 slots
K_TORUS_PLANE = 5     # A=torus, B=plane, 4 slots
K_BOX_BOX = 6         # A=box, B=box: vertex-vs-box both ways, 2*vmax slots
K_SPHERE_HEIGHTMAP = 7   # A=sphere, B=heightmap (not ported)
K_VERTS_HEIGHTMAP = 8    # A=vertex solid, B=heightmap (not ported)
K_CONVEX_CONVEX = 9      # A,B convex clouds: GJK + MTV manifold, 8 slots
K_CONE_PLANE = 10        # A=cone, B=plane, 4 slots
K_SPHERE_TRIMESH = 11    # A=sphere, B=triangle mesh, 4 slots
K_TRIMESH_CONVEX = 12    # A=trimesh, B=box: verts-vs-box + corners-vs-mesh
K_TRIMESH_TRIMESH = 13   # A,B trimeshes (a POLYHEDRON by its hull), 8 slots
# the support-function kinds of the JAX package (not ported): convex pair
# K_SUPPORT_BASE + ta*16 + tb, curved convex vs heightmap K_SUPPORT_HM_BASE +
# ta, triangle mesh vs curved convex K_SUPPORT_TM_BASE + tb
K_SUPPORT_BASE = 100
K_SUPPORT_HM_BASE = 300
K_SUPPORT_TM_BASE = 400
SUPPORT_CONVEX_TYPES = frozenset({SPHERE, BOX, CYLINDER, CONE, TORUS, POLYHEDRON})
CURVED_CONVEX_TYPES = frozenset({CYLINDER, CONE, TORUS})

_SKIP = "skip"

# the kinds the port's narrow phase runs
_PORTED_KINDS = frozenset({
    K_SPHERE_SPHERE, K_SPHERE_PLANE, K_BOX_SPHERE, K_PLANE_GENERIC,
    K_CYLINDER_PLANE, K_TORUS_PLANE, K_BOX_BOX, K_CONVEX_CONVEX, K_CONE_PLANE,
    K_SPHERE_TRIMESH, K_TRIMESH_CONVEX, K_TRIMESH_TRIMESH,
})
_KIND_NAMES = {
    K_SPHERE_SPHERE: "sphere-sphere", K_SPHERE_PLANE: "sphere-plane",
    K_BOX_SPHERE: "box-sphere", K_PLANE_GENERIC: "plane-vertex solid",
    K_CYLINDER_PLANE: "cylinder-plane", K_TORUS_PLANE: "torus-plane",
    K_BOX_BOX: "box-box", K_SPHERE_HEIGHTMAP: "sphere-heightmap",
    K_VERTS_HEIGHTMAP: "vertex solid-heightmap",
    K_CONVEX_CONVEX: "convex-convex", K_CONE_PLANE: "cone-plane",
    K_SPHERE_TRIMESH: "sphere-trimesh", K_TRIMESH_CONVEX: "trimesh-box",
    K_TRIMESH_TRIMESH: "trimesh-trimesh",
}


def kind_name(kind: int) -> str:
    """What a narrow-phase kind code stands for, for messages."""
    kind = int(kind)
    if kind >= K_SUPPORT_TM_BASE:
        return f"trimesh-{_GEOM_NAMES.get(kind - K_SUPPORT_TM_BASE, '?')} support pair"
    if kind >= K_SUPPORT_HM_BASE:
        return f"{_GEOM_NAMES.get(kind - K_SUPPORT_HM_BASE, '?')}-heightmap support pair"
    if kind >= K_SUPPORT_BASE:
        ta, tb = divmod(kind - K_SUPPORT_BASE, 16)
        return (f"{_GEOM_NAMES.get(ta, '?')}-{_GEOM_NAMES.get(tb, '?')} "
                "support pair")
    return _KIND_NAMES.get(kind, "unknown")

# vertex-driven contact-slot cap: pair kinds that emit one slot per vertex cap
# at the VSLOT_CAP deepest vertices (boxes have 8, below the cap)
VSLOT_CAP = 16


def _kind_nslots(kind: int, vmax: int) -> int:
    if kind in (K_SPHERE_SPHERE, K_SPHERE_PLANE, K_BOX_SPHERE):
        return 1
    if kind == K_PLANE_GENERIC:
        return min(vmax, VSLOT_CAP)
    if kind in (K_CYLINDER_PLANE, K_TORUS_PLANE, K_CONE_PLANE):
        return 4
    if kind == K_BOX_BOX:
        return 2 * min(vmax, VSLOT_CAP)
    if kind == K_CONVEX_CONVEX:
        return 8  # 4+4 bidirectional vertex-vs-supporting-plane manifold
    if kind == K_SPHERE_TRIMESH:
        return 4
    if kind == K_TRIMESH_CONVEX:
        # capped mesh verts in box + 8 box corners vs mesh
        return min(vmax, VSLOT_CAP) + 8
    if kind == K_TRIMESH_TRIMESH:
        return 8  # 4+4 deepest vertices-vs-faces, both directions
    raise ValueError(f"unknown kind {kind}")


def _as_tensor(x, device, fdtype):
    """numpy array -> tensor: floats to `fdtype`, ints to int64, bools kept."""
    a = np.asarray(x)
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int64, device=device)
    return torch.tensor(a, dtype=fdtype, device=device)


class ABEntry:
    """Static metadata of one articulated body of a compiled scene."""

    def __init__(self, name, model: amdl.ArticulatedModel, gc_off, q_off, v_off):
        self.name = name
        self.model = model
        self.gc_off = gc_off  # column offset in the global gc vector
        self.q_off = q_off    # offset into State.q_art
        self.v_off = v_off    # offset into State.qd_art


def cached(scene, key, make):
    """A derived static table of `scene` (index tensors, constant Jacobians),
    built once by `make()` and kept beside the host tables."""
    store = scene.host
    if key not in store:
        store[key] = make()
    return store[key]


class _TensorRecord:
    """`.replace(...)` and `.to(device)` for frozen dataclasses of tensors."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        dev = cfg.resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


# array fields of Scene, in the JAX package's order
_SCENE_ARRAYS = (
    "mass", "inv_mass", "inertia", "inv_inertia", "enabled",
    "slot_enabled", "slot_rmax",
    "geom_slot", "geom_pos", "geom_quat", "geom_params", "geom_rmax",
    "pair_g1", "pair_g2", "pair_kind", "pair_slot0", "pair_nslots",
    "slot_pair", "slot_s1", "slot_s2", "slot_eps", "slot_mu_c", "slot_mu_v",
    "slot_compliance", "slot_compliant", "slot_truecone", "slot_kp", "slot_kv",
    "lim_gc_col", "lim_q_idx", "lim_upper", "lim_value", "lim_eps",
    "fr_con", "fr_cos", "fr_sin",
    "geom_verts", "geom_nverts",
    "gravity", "contact_dist_thresh", "min_step_size",
    "dissipation_lambda", "drag_lin", "drag_ang",
)
# the convex hulls of the vertex-cloud geometries (BOX, POLYHEDRON): hull
# triangles of a POLYHEDRON (indices into its cloud) and the candidate
# directions of the exact convex-convex penetration (face normals and edge
# directions, local frame, deduped up to sign)
_HULL_ARRAYS = (
    "geom_faces", "geom_nfaces", "geom_hull_normals", "geom_nhn",
    "geom_hull_edges", "geom_nhe",
)
_SCENE_STATICS = (
    "nb", "ng", "n_pose_slots", "ngc", "nq_art", "nv_art", "n_pairs",
    "n_contacts", "n_friction_rows", "n_limits", "vmax",
    "use_noslip", "use_nqp", "mixed_models", "has_compliant",
    "stab_max_iters", "legacy_velocity_first", "has_dyn_slots",
)


@dataclass(frozen=True, eq=False)
class Scene(_TensorRecord):
    """Static compiled scene, shared by every scenario of a batch."""

    # ---- free rigid bodies (nb,)
    mass: torch.Tensor
    inv_mass: torch.Tensor        # 0 for disabled
    inertia: torch.Tensor         # (nb, 3, 3) body frame
    inv_inertia: torch.Tensor
    enabled: torch.Tensor         # (nb,) bool
    # ---- pose slots (ns = nb + total links)
    slot_enabled: torch.Tensor    # (ns,) bool
    slot_rmax: torch.Tensor       # (ns,) farthest-point distance (CA bound)
    # ---- geometries (ng,)
    geom_slot: torch.Tensor       # (ng,) pose slot
    geom_pos: torch.Tensor        # (ng, 3) local position in slot frame
    geom_quat: torch.Tensor       # (ng, 4) local orientation (xyzw)
    geom_params: torch.Tensor     # (ng, 4)
    geom_rmax: torch.Tensor       # (ng,) shape-only bounding radius
    # ---- candidate pairs (np_,)
    pair_g1: torch.Tensor
    pair_g2: torch.Tensor
    pair_kind: torch.Tensor
    pair_slot0: torch.Tensor
    pair_nslots: torch.Tensor
    # ---- contact slots (K,)
    slot_pair: torch.Tensor       # (K,) owning pair
    slot_s1: torch.Tensor         # (K,) pose slot of geom1
    slot_s2: torch.Tensor         # (K,) pose slot of geom2
    slot_eps: torch.Tensor
    slot_mu_c: torch.Tensor
    slot_mu_v: torch.Tensor
    slot_compliance: torch.Tensor
    slot_compliant: torch.Tensor  # (K,) bool
    slot_truecone: torch.Tensor   # (K,) bool: NK = inf -> true friction cone
    slot_kp: torch.Tensor
    slot_kv: torch.Tensor
    # ---- joint-limit slots (NL,)
    lim_gc_col: torch.Tensor      # (NL,) gc column of the limited dof
    lim_q_idx: torch.Tensor       # (NL,) index into q_art of the dof
    lim_upper: torch.Tensor       # (NL,) bool
    lim_value: torch.Tensor       # (NL,) limit position
    lim_eps: torch.Tensor         # (NL,) limit restitution
    # ---- friction-cone rows (NF,)
    fr_con: torch.Tensor
    fr_cos: torch.Tensor
    fr_sin: torch.Tensor
    # ---- vertex table (plane_generic contacts / CA bounds)
    geom_verts: torch.Tensor      # (ng, VMAX, 3)
    geom_nverts: torch.Tensor     # (ng,)
    # ---- convex hulls (_HULL_ARRAYS)
    geom_faces: torch.Tensor          # (ng, FMAX, 3) hull triangles
    geom_nfaces: torch.Tensor         # (ng,)
    geom_hull_normals: torch.Tensor   # (ng, FN, 3) face normals
    geom_nhn: torch.Tensor            # (ng,)
    geom_hull_edges: torch.Tensor     # (ng, ED, 3) edge directions
    geom_nhe: torch.Tensor            # (ng,)
    # ---- forces / solver config
    gravity: torch.Tensor
    contact_dist_thresh: torch.Tensor
    min_step_size: torch.Tensor
    dissipation_lambda: torch.Tensor  # (nb,)
    drag_lin: torch.Tensor
    drag_ang: torch.Tensor
    # ---- static metadata
    nb: int = 0
    ng: int = 0
    n_pose_slots: int = 0
    ngc: int = 0
    nq_art: int = 0
    nv_art: int = 0
    n_pairs: int = 0
    n_contacts: int = 0
    n_friction_rows: int = 0
    n_limits: int = 0
    vmax: int = 0
    # all contacts have mu >= 100 -> the no-slip MLCP model
    use_noslip: bool = False
    # any contact requests the true friction cone (NK = UINF) -> NQP model
    use_nqp: bool = False
    # contact slots disagree on the impact model -> per-island routing
    mixed_models: bool = False
    has_compliant: bool = False
    stab_max_iters: int = 4
    legacy_velocity_first: bool = False
    has_dyn_slots: bool = False
    arts: Any = ()                # tuple[ABEntry]
    bilaterals: Any = ()
    # (kind, nslots) -> {"kind", "pairs", "slots", "nslots"}, numpy indices
    kind_groups: Any = None
    body_names: Any = None
    # host-side numpy copies of the array fields: static decisions (which
    # bodies are live, whether every restitution is zero, index tables) read
    # these, so they cost no device synchronisation
    host: Any = field(default=None, repr=False)

    @property
    def n_vars(self) -> int:
        """QP variable layout [cn cs ct ncs nct l]
        (UnilateralConstraintProblemData.h:187-205)."""
        return 5 * self.n_contacts + self.n_limits

    @property
    def n_ineq(self) -> int:
        return self.n_contacts + self.n_limits + self.n_friction_rows

    @property
    def n_lcp(self) -> int:
        return self.n_vars + self.n_ineq

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mass.dtype


@dataclass(frozen=True, eq=False)
class State(_TensorRecord):
    """Dynamic simulation state of a batch of B scenarios."""

    pos: torch.Tensor      # (B, nb, 3)
    quat: torch.Tensor     # (B, nb, 4)
    vel: torch.Tensor      # (B, nb, 3)
    omega: torch.Tensor    # (B, nb, 3)
    q_art: torch.Tensor    # (B, nq_art)
    qd_art: torch.Tensor   # (B, nv_art)
    time: torch.Tensor     # (B,)
    zlast: torch.Tensor    # (B, n_lcp)
    zlast_active: torch.Tensor   # (B, K) bool
    min_dist_obs: torch.Tensor   # (B, n_pairs)
    # solver-effort observability (the reference's LCP pivot counters,
    # include/Moby/LCP.h:30), accumulated over the mini-steps of the last
    # `step` call; (B,) int32
    solver_pivots: Optional[torch.Tensor] = None
    solver_fallbacks: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.pos.shape[0]

    def expand(self, B: int) -> "State":
        """A batch of B copies of a single-scenario state."""
        if self.batch != 1:
            raise ValueError("expand() needs a state of batch 1")
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).expand(
                (B,) + getattr(self, f.name).shape[1:]).clone()
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        })


@dataclass
class BodyDef:
    name: str
    mass: float = 0.0
    inertia: np.ndarray = None
    pos: np.ndarray = None
    quat: np.ndarray = None
    lin_vel: np.ndarray = None
    ang_vel: np.ndarray = None
    enabled: bool = True
    dissipation: float = 1.0
    compliant: bool = False


@dataclass
class GeomDef:
    body: str
    gtype: int
    params: np.ndarray
    pos: np.ndarray = None
    quat: np.ndarray = None
    verts: np.ndarray = None
    rmax: float = None           # override for the CA motion-bound radius
    heights: np.ndarray = None
    faces: np.ndarray = None


@dataclass
class ContactParams:
    """Reference ContactParameters defaults (ContactParameters.cpp:23-26)."""

    epsilon: float = 0.0
    mu_coulomb: float = 0.0
    mu_viscous: float = 0.0
    nk: int = 4            # friction-cone edges; <= 0 means the true cone
    compliance: float = 0.0
    penalty_kp: float = 0.0
    penalty_kv: float = 0.0
    # cap on this pair's contact-manifold slots (0 = kernel default)
    max_slots: int = 0


def box_vertices(hx, hy, hz) -> np.ndarray:
    return np.array(
        [
            [sx * hx, sy * hy, sz * hz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ]
    )


def _hull_candidate_dirs(verts):
    """Face unit normals and edge unit directions (each deduped up to sign)
    of conv(verts), from the native quickhull. Returns
    (normals (FN,3), edge_dirs (ED,3)), or (None, None) for a degenerate
    (flat or collinear) vertex cloud."""
    from ..geometry import hull

    try:
        hv, faces = hull.convex_hull(np.asarray(verts, np.float64))
    except ValueError:
        return None, None
    if len(faces) == 0:
        return None, None

    def dedup_dirs(d):
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-300)
        # canonical hemisphere (sign-insensitive consumers evaluate both)
        flip = (d[:, 0] < -1e-12) | (
            (np.abs(d[:, 0]) <= 1e-12) & (d[:, 1] < -1e-12)
        ) | (
            (np.abs(d[:, 0]) <= 1e-12) & (np.abs(d[:, 1]) <= 1e-12)
            & (d[:, 2] < 0)
        )
        d = np.where(flip[:, None], -d, d)
        return np.unique(np.round(d, 9), axis=0)

    a, b, c = hv[faces[:, 0]], hv[faces[:, 1]], hv[faces[:, 2]]
    fn = np.cross(b - a, c - a)
    ln = np.linalg.norm(fn, axis=1)
    fn = fn[ln > 1e-12]
    normals = dedup_dirs(fn)

    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]
    )
    ev = hv[edges[:, 1]] - hv[edges[:, 0]]
    le = np.linalg.norm(ev, axis=1)
    ev = ev[le > 1e-12]
    edge_dirs = dedup_dirs(ev)
    return normals, edge_dirs


def sphere_inertia(mass, r):
    return np.eye(3) * (2.0 / 5.0 * mass * r * r)


def box_inertia(mass, hx, hy, hz):
    lx, ly, lz = 2 * hx, 2 * hy, 2 * hz
    return np.diag(
        [
            mass / 12.0 * (ly * ly + lz * lz),
            mass / 12.0 * (lx * lx + lz * lz),
            mass / 12.0 * (lx * lx + ly * ly),
        ]
    )


def cylinder_inertia(mass, r, h):
    ix = mass * (3 * r * r + h * h) / 12.0
    return np.diag([ix, 0.5 * mass * r * r, ix])


def _np_qmul(q1, q2):
    """Hamilton product of two xyzw quaternions, in numpy."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _check_ported(statics: dict, kind_groups: dict):
    """Refuse what the port does not run, naming the feature."""
    if statics.get("has_dyn_slots"):
        raise NotImplementedError("pair pooling is not ported yet")
    for key, grp in (kind_groups or {}).items():
        kind = int(grp["kind"])
        if "kernel" in grp or kind < 0:
            raise NotImplementedError("plugin contact kernels are not ported yet")
        if grp.get("pooled"):
            raise NotImplementedError("pair pooling is not ported yet")
        if kind not in _PORTED_KINDS:
            raise NotImplementedError(
                f"narrow-phase kind {kind} ({kind_name(kind)} pairs) is not "
                "ported yet (ported: kinds 0-6 and 9-13)")


def scene_from_arrays(fields: dict, device, dtype=None) -> Scene:
    """Build a :class:`Scene` from a dict of numpy arrays and Python statics
    — the fields of a compiled scene of either package, arrays already
    converted with ``np.asarray``. The articulated entries ``arts`` may be
    either package's: each model is rebuilt from its plain fields
    (`dynamics.model.copy_model`). Entries the port has no consumer for
    (the heightmap grids) are ignored; features it does not run raise
    ``NotImplementedError``."""
    dev = cfg.resolve_device(device)
    fdtype = cfg.torch_dtype(dtype) if dtype is not None else cfg.default_dtype(dev)
    statics = {k: fields[k] for k in _SCENE_STATICS if k in fields}
    statics["arts"] = tuple(
        e if isinstance(e.model, amdl.ArticulatedModel)
        else ABEntry(e.name, amdl.copy_model(e.model), int(e.gc_off),
                     int(e.q_off), int(e.v_off))
        for e in (fields.get("arts") or ()))
    from ..sim import bilateral

    statics["bilaterals"] = tuple(
        bilateral.from_fields(b) for b in (fields.get("bilaterals") or ()))
    kind_groups = {}
    for key, grp in (fields.get("kind_groups") or {}).items():
        g = dict(grp)
        g["pairs"] = np.asarray(g["pairs"], np.int64)
        g["slots"] = np.asarray(g["slots"], np.int64)
        kind_groups[(int(key[0]), int(key[1]))] = g
    _check_ported(statics, kind_groups)
    np_dt = cfg.numpy_dtype(fdtype)
    host = {}
    for k in _SCENE_ARRAYS + _HULL_ARRAYS:
        a = np.asarray(fields[k])
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np_dt)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        host[k] = a
    arrays = {k: _as_tensor(v, dev, fdtype) for k, v in host.items()}
    body_names = fields.get("body_names")
    return Scene(
        **arrays, **statics, kind_groups=kind_groups,
        body_names=None if body_names is None else tuple(body_names),
        host=host,
    )


_STATE_ARRAYS = (
    "pos", "quat", "vel", "omega", "q_art", "qd_art", "time", "zlast",
    "zlast_active", "min_dist_obs", "solver_pivots", "solver_fallbacks",
)


def state_from_arrays(fields: dict, device, dtype=None) -> State:
    """Build a :class:`State` from a dict of numpy arrays. A single-scenario
    state (``pos`` of shape (nb, 3)) gets a leading batch dimension of 1;
    a batched one ((B, nb, 3)) is taken as it is."""
    dev = cfg.resolve_device(device)
    fdtype = cfg.torch_dtype(dtype) if dtype is not None else cfg.default_dtype(dev)
    batched = np.asarray(fields["pos"]).ndim == 3
    out = {}
    for k in _STATE_ARRAYS:
        v = fields.get(k)
        if v is None:
            out[k] = None
            continue
        a = np.asarray(v)
        if not batched:
            a = a[None]
        if k in ("solver_pivots", "solver_fallbacks"):
            out[k] = torch.as_tensor(a.astype(np.int32), device=dev)
        else:
            out[k] = _as_tensor(a, dev, fdtype)
    return State(**out)


@dataclass
class ABDef:
    """Articulated body under construction."""

    name: str
    model: amdl.ArticulatedModel
    q0: np.ndarray = None
    qd0: np.ndarray = None
    link_names: list = None


class SceneBuilder:
    """Host-side scene assembly (XMLReader + Simulator setup equivalent)."""

    def __init__(self, dtype=None):
        self.dtype = dtype          # None: chosen from the device at compile
        self.bodies: list[BodyDef] = []
        self.geoms: list[GeomDef] = []
        self.arts: list[ABDef] = []
        self.contact_params: dict[tuple[str, str], ContactParams] = {}
        self.gravity = np.zeros(3)
        self.contact_dist_thresh = 1e-6
        self.min_step_size = cfg.NEAR_ZERO_F64
        self.stab_max_iters = 4
        self.legacy_velocity_first = False
        self.disabled_pairs: set[tuple[str, str]] = set()
        self.drag_lin: dict = {}
        self.drag_ang: dict = {}
        self._gears: list = []
        self._points: list = []
        self._planars: list = []
        # features accepted above but refused by compile(), by name
        self._unported: list[str] = []

    def add_articulated(self, name, model: amdl.ArticulatedModel, q0=None,
                        qd0=None, link_names=None) -> ABDef:
        ab = ABDef(
            name=name,
            model=model,
            q0=np.asarray(q0) if q0 is not None else model.neutral_q(),
            qd0=np.asarray(qd0) if qd0 is not None else np.zeros(model.nv),
            link_names=link_names or [lk.name for lk in model.links],
        )
        self.arts.append(ab)
        return ab

    # ---------------- bilateral (implicit) constraints ----------------
    def add_gear_constraint(self, ab_name, link_a, link_b, ratio):
        """Gear ratio coupling between two 1-dof joints of an articulated
        body (`Moby::Gears`, include/Moby/Gears.h:40-45): the OUTBOARD link
        names identify the joints."""
        self._gears.append((ab_name, link_a, link_b, float(ratio)))

    def add_point_constraint(self, body1, anchor1, body2, anchor2):
        """Ball-joint loop constraint pinning two bodies' anchor points
        (simulator-level implicit joints, src/Simulator.cpp:604-805)."""
        self._points.append(
            (body1, np.asarray(anchor1, float), body2, np.asarray(anchor2, float)))

    def add_planar_constraint(self, outboard, inboard, normal):
        """Planar implicit joint: `outboard` translates in `inboard`'s plane
        and rotates about its normal (Moby::PlanarJoint as a simulator-level
        ImplicitConstraint). `normal` is given in the inboard body's frame."""
        self._planars.append((outboard, inboard, np.asarray(normal, float)))

    # ---------------- not ported yet: recorded, refused at compile ----------
    def add_custom_pair(self, body1, body2, kernel, nslots):
        self._unported.append("plugin contact kernels")

    def set_pair_pool(self, gtype_a, gtype_b, max_pairs: int):
        self._unported.append("pair pooling")

    # ---------------- bodies / geoms ----------------
    def add_body(self, name, **kw) -> BodyDef:
        b = BodyDef(name=name, **kw)
        if b.inertia is None:
            b.inertia = np.eye(3)
        if b.pos is None:
            b.pos = np.zeros(3)
        if b.quat is None:
            b.quat = np.array([0.0, 0.0, 0.0, 1.0])
        if b.lin_vel is None:
            b.lin_vel = np.zeros(3)
        if b.ang_vel is None:
            b.ang_vel = np.zeros(3)
        self.bodies.append(b)
        return b

    def add_geom(self, body, gtype, params, pos=None, quat=None, verts=None,
                 rmax=None, heights=None, faces=None):
        g = GeomDef(
            body=body,
            gtype=gtype,
            params=np.asarray(params, dtype=np.float64),
            pos=np.zeros(3) if pos is None else np.asarray(pos, np.float64),
            quat=np.array([0, 0, 0, 1.0]) if quat is None else np.asarray(quat, np.float64),
            verts=verts,
            rmax=rmax,
            heights=heights,
            faces=None if faces is None else np.asarray(faces, np.int32),
        )
        if g.gtype == TRIMESH and (g.verts is None or g.faces is None):
            raise ValueError("TRIMESH geometry needs verts and faces")
        if g.gtype == BOX and g.verts is None:
            g.verts = box_vertices(*g.params[:3])
        self.geoms.append(g)
        return g

    def set_contact_params(self, name1, name2, cp: ContactParams):
        self.contact_params[tuple(sorted((name1, name2)))] = cp

    def set_gravity(self, g):
        self.gravity = np.asarray(g, np.float64)

    # ---------------- compile ----------------
    def _bilaterals(self, slot_names, art_entries):
        """The recorded gear, point and planar constraints as `Bilateral`
        records; a planar joint's offset and relative rotation are taken
        from the initial poses."""
        from ..sim.bilateral import GEAR, PLANAR, POINT, Bilateral

        out = []
        for (abn, la, lb, ratio) in self._gears:
            k = [i for i, ab in enumerate(self.arts) if ab.name == abn][0]
            ab, ent = self.arts[k], art_entries[k]
            m = ab.model
            ia, ib = ab.link_names.index(la), ab.link_names.index(lb)
            out.append(Bilateral(
                btype=GEAR,
                col_a=ent.gc_off + m.v_off[ia], col_b=ent.gc_off + m.v_off[ib],
                ratio=ratio,
                q_idx_a=ent.q_off + m.q_off[ia], q_idx_b=ent.q_off + m.q_off[ib],
                q0_a=float(ab.q0[m.q_off[ia]]), q0_b=float(ab.q0[m.q_off[ib]]),
            ))
        for (b1n, a1, b2n, a2) in self._points:
            out.append(Bilateral(
                btype=POINT, slot_a=slot_names[b1n], slot_b=slot_names[b2n],
                anchor_a=tuple(a1), anchor_b=tuple(a2)))

        def pose(name):
            body = next((b for b in self.bodies if b.name == name), None)
            if body is None:
                raise ValueError(f"planar constraint on unknown body {name}")
            return np.asarray(body.pos, float), np.asarray(body.quat, float)

        for (out_n, in_n, nrm) in self._planars:
            (pa0, qa0), (pb0, qb0) = pose(out_n), pose(in_n)
            nrm = nrm / max(np.linalg.norm(nrm), 1e-300)
            qb0_inv = np.array([-qb0[0], -qb0[1], -qb0[2], qb0[3]])
            n_w0 = _np_qmul(_np_qmul(qb0, np.append(nrm, 0.0)), qb0_inv)[:3]
            out.append(Bilateral(
                btype=PLANAR, slot_a=slot_names[out_n], slot_b=slot_names[in_n],
                normal=tuple(nrm), offset0=float(n_w0 @ (pa0 - pb0)),
                qrel0=tuple(_np_qmul(qa0, qb0_inv)),
            ))
        return tuple(out)

    def _pair_kind(self, ta, tb):
        """(kind, flip) of a geometry-type pair: the JAX package's table,
        kinds the port does not run included (compile refuses those)."""
        if ta == SPHERE and tb == SPHERE:
            return K_SPHERE_SPHERE, False
        if ta == SPHERE and tb == PLANE:
            return K_SPHERE_PLANE, False
        if ta == PLANE and tb == SPHERE:
            return K_SPHERE_PLANE, True
        if ta == SPHERE and tb == BOX:
            return K_BOX_SPHERE, True
        if ta == BOX and tb == SPHERE:
            return K_BOX_SPHERE, False
        if ta in (BOX, POLYHEDRON) and tb == PLANE:
            return K_PLANE_GENERIC, True
        if ta == PLANE and tb in (BOX, POLYHEDRON):
            return K_PLANE_GENERIC, False
        if ta == CYLINDER and tb == PLANE:
            return K_CYLINDER_PLANE, False
        if ta == PLANE and tb == CYLINDER:
            return K_CYLINDER_PLANE, True
        if ta == CONE and tb == PLANE:
            return K_CONE_PLANE, False
        if ta == PLANE and tb == CONE:
            return K_CONE_PLANE, True
        if ta == TORUS and tb == PLANE:
            return K_TORUS_PLANE, False
        if ta == PLANE and tb == TORUS:
            return K_TORUS_PLANE, True
        if ta == BOX and tb == BOX:
            return K_BOX_BOX, False
        if ta == SPHERE and tb == HEIGHTMAP:
            return K_SPHERE_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb == SPHERE:
            return K_SPHERE_HEIGHTMAP, True
        if ta in (BOX, POLYHEDRON) and tb == HEIGHTMAP:
            return K_VERTS_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb in (BOX, POLYHEDRON):
            return K_VERTS_HEIGHTMAP, True
        if ta in CURVED_CONVEX_TYPES and tb == HEIGHTMAP:
            return K_SUPPORT_HM_BASE + ta, False
        if ta == HEIGHTMAP and tb in CURVED_CONVEX_TYPES:
            return K_SUPPORT_HM_BASE + tb, True
        if ta == POLYHEDRON and tb in (POLYHEDRON, BOX):
            return K_CONVEX_CONVEX, False
        if ta == BOX and tb == POLYHEDRON:
            return K_CONVEX_CONVEX, False
        if ta == TRIMESH and tb == PLANE:
            return K_PLANE_GENERIC, True
        if ta == PLANE and tb == TRIMESH:
            return K_PLANE_GENERIC, False
        if ta == TRIMESH and tb == HEIGHTMAP:
            return K_VERTS_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb == TRIMESH:
            return K_VERTS_HEIGHTMAP, True
        if ta == SPHERE and tb == TRIMESH:
            return K_SPHERE_TRIMESH, False
        if ta == TRIMESH and tb == SPHERE:
            return K_SPHERE_TRIMESH, True
        if ta == TRIMESH and tb == BOX:
            return K_TRIMESH_CONVEX, False
        if ta == BOX and tb == TRIMESH:
            return K_TRIMESH_CONVEX, True
        if ta == TRIMESH and tb == TRIMESH:
            return K_TRIMESH_TRIMESH, False
        if ta == TRIMESH and tb == POLYHEDRON:
            return K_TRIMESH_TRIMESH, False
        if ta == POLYHEDRON and tb == TRIMESH:
            return K_TRIMESH_TRIMESH, True
        if ta == TRIMESH and tb in CURVED_CONVEX_TYPES:
            return K_SUPPORT_TM_BASE + tb, False
        if ta in CURVED_CONVEX_TYPES and tb == TRIMESH:
            return K_SUPPORT_TM_BASE + ta, True
        if ta in SUPPORT_CONVEX_TYPES and tb in SUPPORT_CONVEX_TYPES:
            if ta <= tb:
                return K_SUPPORT_BASE + ta * 16 + tb, False
            return K_SUPPORT_BASE + tb * 16 + ta, True
        # two fixed environment fields / plugin ghost anchors: nothing to do
        if ta == NONE or tb == NONE:
            return _SKIP, False
        if {ta, tb} <= {PLANE, HEIGHTMAP}:
            return _SKIP, False
        return None, False

    def compile(self, device="cuda", dtype=None):
        """Compile to (Scene, State of batch 1) on `device`. The dtype is the
        `SceneBuilder`'s own, else `dtype`, else the device's default (float32 on the
        card, float64 on the CPU)."""
        dev = cfg.resolve_device(device)
        fdtype = cfg.torch_dtype(
            dtype if dtype is not None
            else self.dtype if self.dtype is not None
            else cfg.default_dtype(dev))
        dt = cfg.numpy_dtype(fdtype)

        if self._unported:
            raise NotImplementedError(
                f"{self._unported[0]} are not ported yet")

        nb = len(self.bodies)
        # pose-slot map: free body i -> slot i, link l of ab k -> nb + offset
        slot_names = {b.name: i for i, b in enumerate(self.bodies)}
        slot_owner = [("free", i, 0) for i in range(nb)]
        total_links = 0
        gc_off = 6 * nb
        q_off = v_off = 0
        art_entries = []
        for k, ab in enumerate(self.arts):
            for l, lname in enumerate(ab.link_names):
                slot_names[f"{ab.name}/{lname}"] = nb + total_links + l
                slot_owner.append(("link", k, l))
            art_entries.append(ABEntry(ab.name, ab.model, gc_off, q_off, v_off))
            total_links += ab.model.nl
            gc_off += ab.model.nv
            q_off += ab.model.nq
            v_off += ab.model.nv
        ns = nb + total_links
        ngc = gc_off
        nq_art, nv_art = q_off, v_off

        mass = np.array([b.mass for b in self.bodies], dt) if nb else np.zeros(0, dt)
        inertia = (
            np.stack([b.inertia for b in self.bodies]).astype(dt)
            if nb
            else np.zeros((0, 3, 3), dt)
        )
        enabled = np.array([b.enabled for b in self.bodies], bool)
        inv_mass = np.where(
            enabled & (mass > 0), 1.0 / np.where(mass > 0, mass, 1.0), 0.0
        ).astype(dt)
        inv_inertia = np.zeros_like(inertia)
        for i, b in enumerate(self.bodies):
            if enabled[i] and b.mass > 0:
                inv_inertia[i] = np.linalg.inv(b.inertia)
        slot_enabled = np.concatenate([enabled, np.ones(total_links, bool)])

        all_geoms = list(self.geoms)
        ng = len(all_geoms)
        geom_slot = np.array(
            [slot_names[g.body] for g in all_geoms], np.int64
        ) if ng else np.zeros(0, np.int64)
        geom_pos = np.stack([g.pos for g in all_geoms]).astype(dt) if ng else np.zeros((0, 3), dt)
        geom_quat = np.stack([g.quat for g in all_geoms]).astype(dt) if ng else np.zeros((0, 4), dt)
        geom_params = np.zeros((ng, 4), dt)
        for i, g in enumerate(all_geoms):
            geom_params[i, : len(g.params)] = g.params

        vmax = max([1] + [len(g.verts) for g in all_geoms if g.verts is not None])
        geom_verts = np.zeros((ng, vmax, 3), dt)
        geom_nverts = np.zeros(ng, np.int64)
        # the face table: a mesh's own triangles, and the hull triangles of a
        # convex cloud as indices into its own vertex order (degenerate
        # clouds have none)
        faces_of = {i: g.faces for i, g in enumerate(all_geoms)
                    if g.faces is not None}
        for i, g in enumerate(all_geoms):
            if g.gtype == POLYHEDRON and g.faces is None and g.verts is not None:
                from ..geometry import hull

                try:
                    hv, hf = hull.convex_hull(np.asarray(g.verts, np.float64))
                except ValueError:
                    continue
                if len(hf):
                    lookup = {tuple(np.round(v, 12)): k for k, v in
                              enumerate(np.asarray(g.verts, np.float64))}
                    remap = np.array([lookup[tuple(np.round(v, 12))] for v in hv],
                                     np.int64)
                    faces_of[i] = remap[hf]
        fmax = max([1] + [len(f) for f in faces_of.values()])
        geom_faces = np.zeros((ng, fmax, 3), np.int64)
        geom_nfaces = np.zeros(ng, np.int64)
        # candidate directions of the exact convex-convex penetration
        hull_dirs = {}
        for i, g in enumerate(all_geoms):
            if g.verts is not None and g.gtype in (BOX, POLYHEDRON):
                nrm_, ed_ = _hull_candidate_dirs(g.verts)
                if nrm_ is not None:
                    hull_dirs[i] = (nrm_, ed_)
        fn_max = max([1] + [len(v[0]) for v in hull_dirs.values()])
        ed_max = max([1] + [len(v[1]) for v in hull_dirs.values()])
        geom_hull_normals = np.zeros((ng, fn_max, 3), dt)
        geom_nhn = np.zeros(ng, np.int64)
        geom_hull_edges = np.zeros((ng, ed_max, 3), dt)
        geom_nhe = np.zeros(ng, np.int64)
        for i, (nrm_, ed_) in hull_dirs.items():
            geom_hull_normals[i, : len(nrm_)] = nrm_
            geom_nhn[i] = len(nrm_)
            geom_hull_edges[i, : len(ed_)] = ed_
            geom_nhe[i] = len(ed_)
        for i, g in enumerate(all_geoms):
            if g.verts is not None:
                geom_verts[i, : len(g.verts)] = g.verts
                geom_nverts[i] = len(g.verts)
            if i in faces_of:
                geom_faces[i, : len(faces_of[i])] = faces_of[i]
                geom_nfaces[i] = len(faces_of[i])

        def shape_radius(g):
            """Bounding radius about the geometry's origin; inf unbounded."""
            t = g.gtype
            if t == SPHERE:
                return g.params[0]
            if t == BOX:
                return float(np.linalg.norm(g.params[:3]))
            if t in (CYLINDER, CONE):
                return float(math.hypot(g.params[0], g.params[1] / 2))
            if t == TORUS:
                return float(g.params[0] + g.params[1])
            if t in (POLYHEDRON, TRIMESH) and g.verts is not None:
                return float(np.max(np.linalg.norm(g.verts, axis=1)))
            return np.inf  # plane, heightmap

        # rmax per pose slot (reference CCD.cpp:739) and the shape-only
        # bounding radius per geometry
        slot_rmax = np.zeros(ns, dt)
        geom_rmax = np.zeros(ng, dt)
        for i, g in enumerate(all_geoms):
            geom_rmax[i] = shape_radius(g)
            s = geom_slot[i]
            if g.rmax is not None:
                slot_rmax[s] = max(slot_rmax[s], g.rmax)
                continue
            r = shape_radius(g)
            off = np.linalg.norm(g.pos)
            slot_rmax[s] = max(slot_rmax[s], off + (r if np.isfinite(r) else 0.0))

        # candidate pairs: geometry pairs across distinct pose slots where at
        # least one side is dynamic (enabled) — CollisionDetection.cpp:48-54
        def slot_cp_names(s):
            """ContactParameters names for this slot, most specific first:
            "ab/link", then the articulated body (geom -> body -> abody,
            ConstraintSimulator.cpp:82-155)."""
            kind, k, l = slot_owner[s]
            if kind == "free":
                return [self.bodies[k].name]
            ab = self.arts[k]
            return [f"{ab.name}/{ab.link_names[l]}", ab.name]

        def slot_names_all(s):
            """Names this slot answers to for DisabledPair matching: the
            body or link name and, for a link, its articulated body's."""
            kind, k, l = slot_owner[s]
            if kind == "free":
                return [self.bodies[k].name]
            return [self.arts[k].link_names[l], self.arts[k].name]

        def pair_disabled(si, sj):
            return any(tuple(sorted((a, b))) in self.disabled_pairs
                       for a in slot_names_all(si) for b in slot_names_all(sj))

        pair_rows = []
        for i in range(ng):
            for j in range(i + 1, ng):
                si, sj = int(geom_slot[i]), int(geom_slot[j])
                if si == sj:
                    continue
                if not (slot_enabled[si] or slot_enabled[sj]):
                    continue
                if pair_disabled(si, sj):
                    continue
                ta, tb = all_geoms[i].gtype, all_geoms[j].gtype
                kind, flip = self._pair_kind(ta, tb)
                if kind is _SKIP:
                    continue
                what = (f"{_GEOM_NAMES.get(ta, ta)} vs {_GEOM_NAMES.get(tb, tb)} "
                        f"(bodies '{all_geoms[i].body}' / '{all_geoms[j].body}')")
                if kind is None:
                    raise ValueError(f"no narrow-phase kernel for geometry pair {what}")
                if kind not in _PORTED_KINDS or not {ta, tb} <= _PORTED_GEOMS:
                    raise NotImplementedError(
                        f"narrow-phase kind {kind} ({kind_name(kind)}) of the "
                        f"pair {what} is not ported yet")
                ga, gb = (j, i) if flip else (i, j)
                pair_rows.append((ga, gb, kind))
        for g in all_geoms:
            if g.gtype not in _PORTED_GEOMS:
                raise NotImplementedError(
                    f"{_GEOM_NAMES.get(g.gtype, g.gtype)} geometry (body "
                    f"'{g.body}') is not ported yet")

        n_pairs = len(pair_rows)
        pair_g1 = np.array([p[0] for p in pair_rows], np.int64)
        pair_g2 = np.array([p[1] for p in pair_rows], np.int64)
        pair_kind = np.array([p[2] for p in pair_rows], np.int64)

        # contact slots
        s_pair, s_s1, s_s2 = [], [], []
        s_eps, s_mu_c, s_mu_v, s_comp, s_nk = [], [], [], [], []
        s_kp, s_kv, s_truecone, s_compliant = [], [], [], []

        def _body_compliant(slot):
            kind, k, _ = slot_owner[slot]
            return self.bodies[k].compliant if kind == "free" else False
        # kinds whose kernels take an nslots argument and top-k to it (the
        # only ones a per-pair max_slots cap may shrink)
        _CAPPABLE = {K_PLANE_GENERIC, K_BOX_BOX, K_TRIMESH_CONVEX}

        def _cp_for(s1, s2):
            for n1 in slot_cp_names(s1):
                for n2 in slot_cp_names(s2):
                    key = tuple(sorted((n1, n2)))
                    if key in self.contact_params:
                        return self.contact_params[key]
            return ContactParams()

        pair_cp, pair_nsl = [], []
        for (ga, gb, kind) in pair_rows:
            nsl = _kind_nslots(kind, vmax)
            cp = _cp_for(int(geom_slot[ga]), int(geom_slot[gb]))
            if cp.max_slots > 0 and kind in _CAPPABLE:
                nsl = min(nsl, cp.max_slots)
            pair_cp.append(cp)
            pair_nsl.append(nsl)

        group_of: dict = {}
        for p, (ga, gb, kind) in enumerate(pair_rows):
            group_of.setdefault((int(kind), int(pair_nsl[p])), []).append(p)

        pair_slot0 = np.zeros(n_pairs, np.int64)
        pair_nslots = np.zeros(n_pairs, np.int64)
        for p, (ga, gb, kind) in enumerate(pair_rows):
            nsl = pair_nsl[p]
            cp = pair_cp[p]
            pair_slot0[p] = len(s_pair)
            s1 = int(geom_slot[ga])
            s2 = int(geom_slot[gb])
            pair_nslots[p] = nsl
            for _ in range(nsl):
                s_pair.append(p)
                s_s1.append(s1)
                s_s2.append(s2)
                s_eps.append(cp.epsilon)
                s_mu_c.append(cp.mu_coulomb)
                s_mu_v.append(cp.mu_viscous)
                s_comp.append(cp.compliance)
                # nk <= 0 = true cone (NQP); friction rows are then unused
                s_nk.append(max(4, cp.nk) if cp.nk > 0 else 4)
                s_truecone.append(cp.nk <= 0)
                s_compliant.append(_body_compliant(s1) or _body_compliant(s2))
                s_kp.append(cp.penalty_kp)
                s_kv.append(cp.penalty_kv)
        K = len(s_pair)

        # friction rows: θ_j = j/(NK/2-1)·π/2 (setup_QP:461-479)
        fr_con, fr_cos, fr_sin = [], [], []
        for i in range(K):
            half = s_nk[i] // 2
            for j in range(half):
                theta = (j / (half - 1)) * (math.pi / 2) if half > 1 else 0.0
                fr_con.append(i)
                fr_cos.append(math.cos(theta))
                fr_sin.append(math.sin(theta))
        NF = len(fr_con)

        # joint-limit slots: 2 per dof with a finite limit
        lim_gc_col, lim_q_idx, lim_upper, lim_value, lim_eps = [], [], [], [], []
        for k, ab in enumerate(self.arts):
            ent = art_entries[k]
            m = ab.model
            for li, lk in enumerate(m.links):
                jd = lk.joint
                if jd.hi is None and jd.lo is None:
                    continue
                for d in range(amdl.NV[m.jtype[li]]):
                    hi = jd.hi[d] if jd.hi is not None else np.inf
                    lo = jd.lo[d] if jd.lo is not None else -np.inf
                    for upper, val in ((True, hi), (False, lo)):
                        if np.isfinite(val):
                            lim_gc_col.append(ent.gc_off + m.v_off[li] + d)
                            lim_q_idx.append(ent.q_off + m.q_off[li] + d)
                            lim_upper.append(upper)
                            lim_value.append(val)
                            lim_eps.append(jd.restitution or 0.0)
        NL = len(lim_gc_col)
        bilaterals = self._bilaterals(slot_names, art_entries)

        kind_groups = {}
        for gkey, v in group_of.items():
            kind_groups[gkey] = {
                "kind": gkey[0],
                "pairs": np.array(v, np.int64),
                "slots": np.concatenate(
                    [pair_slot0[p] + np.arange(pair_nslots[p], dtype=np.int64)
                     for p in v]
                ),
                "nslots": gkey[1],
            }

        rigid = [not c for c in s_compliant]
        rigid_mu = [m for m, r in zip(s_mu_c, rigid) if r]
        rigid_tc = [t for t, r in zip(s_truecone, rigid) if r]
        fields = dict(
            mass=mass, inv_mass=inv_mass, inertia=inertia,
            inv_inertia=inv_inertia, enabled=enabled,
            slot_enabled=slot_enabled, slot_rmax=slot_rmax,
            geom_slot=geom_slot, geom_pos=geom_pos, geom_quat=geom_quat,
            geom_params=geom_params, geom_rmax=geom_rmax,
            pair_g1=pair_g1, pair_g2=pair_g2, pair_kind=pair_kind,
            pair_slot0=pair_slot0, pair_nslots=pair_nslots,
            slot_pair=np.array(s_pair, np.int64),
            slot_s1=np.array(s_s1, np.int64),
            slot_s2=np.array(s_s2, np.int64),
            slot_eps=np.array(s_eps, dt),
            slot_mu_c=np.array(s_mu_c, dt),
            slot_mu_v=np.array(s_mu_v, dt),
            slot_compliance=np.array(s_comp, dt),
            slot_compliant=np.array(s_compliant, bool) if K else np.zeros(0, bool),
            slot_truecone=np.array(s_truecone, bool) if K else np.zeros(0, bool),
            slot_kp=np.array(s_kp, dt),
            slot_kv=np.array(s_kv, dt),
            lim_gc_col=np.array(lim_gc_col, np.int64),
            lim_q_idx=np.array(lim_q_idx, np.int64),
            lim_upper=np.array(lim_upper, bool),
            lim_value=np.array(lim_value, dt),
            lim_eps=np.array(lim_eps, dt),
            fr_con=np.array(fr_con, np.int64),
            fr_cos=np.array(fr_cos, dt),
            fr_sin=np.array(fr_sin, dt),
            geom_verts=geom_verts, geom_nverts=geom_nverts,
            geom_faces=geom_faces, geom_nfaces=geom_nfaces,
            geom_hull_normals=geom_hull_normals, geom_nhn=geom_nhn,
            geom_hull_edges=geom_hull_edges, geom_nhe=geom_nhe,
            gravity=self.gravity.astype(dt),
            contact_dist_thresh=np.array(self.contact_dist_thresh, dt),
            min_step_size=np.array(self.min_step_size, dt),
            dissipation_lambda=np.array([b.dissipation for b in self.bodies], dt),
            drag_lin=np.array(
                [self.drag_lin.get(b.name, 0.0) for b in self.bodies], dt),
            drag_ang=np.array(
                [self.drag_ang.get(b.name, 0.0) for b in self.bodies], dt),
            nb=nb, ng=ng, n_pose_slots=ns, ngc=ngc, nq_art=nq_art,
            nv_art=nv_art, n_pairs=n_pairs, n_contacts=K,
            n_friction_rows=NF, n_limits=NL,
            vmax=vmax,
            use_noslip=bool(K > 0 and all(m >= 1e2 for m in rigid_mu)
                            and not all(s_compliant)),
            use_nqp=bool(K > 0 and any(rigid_tc)),
            # slots disagree on the model -> islands can route differently
            # (rigid slots only; compliant slots never reach the impact solve)
            mixed_models=bool(
                K > 0
                and (
                    (any(m >= 1e2 for m in rigid_mu)
                     and any(m < 1e2 for m in rigid_mu))
                    or (any(rigid_tc)
                        and any((not t) and m < 1e2
                                for t, m in zip(rigid_tc, rigid_mu)))
                )
            ),
            has_compliant=bool(any(s_compliant)),
            stab_max_iters=int(self.stab_max_iters),
            legacy_velocity_first=bool(self.legacy_velocity_first),
            has_dyn_slots=False,
            arts=tuple(art_entries),
            bilaterals=bilaterals,
            kind_groups=kind_groups,
            body_names=tuple(b.name for b in self.bodies),
        )
        scene = scene_from_arrays(fields, dev, fdtype)

        def stack(attr, width):
            return (np.stack([getattr(b, attr) for b in self.bodies]).astype(dt)
                    if nb else np.zeros((0, width), dt))

        def art_vec(attr):
            return (np.concatenate([getattr(ab, attr) for ab in self.arts]).astype(dt)
                    if self.arts else np.zeros(0, dt))

        state = state_from_arrays(dict(
            pos=stack("pos", 3), quat=stack("quat", 4),
            vel=stack("lin_vel", 3), omega=stack("ang_vel", 3),
            q_art=art_vec("q0"), qd_art=art_vec("qd0"),
            time=np.array(0.0, dt),
            zlast=np.zeros(scene.n_lcp, dt),
            zlast_active=np.zeros(K, bool),
            min_dist_obs=np.zeros(n_pairs, dt),
            solver_pivots=np.zeros((), np.int32),
            solver_fallbacks=np.zeros((), np.int32),
        ), dev, fdtype)
        return scene, state
