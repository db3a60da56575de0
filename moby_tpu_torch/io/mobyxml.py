"""Moby XML scene reader (counterpart of ``moby_tpu/io/mobyxml.py``).

Parses the reference's XML scene format (tag registry:
src/XMLReader.cpp:151-204) into the port's compiled `Scene` + initial
`State` on a device:

    scene, state, opts = mobyxml.load("scenes/fixed-articulated-table.xml",
                                      device="cuda")

Covered: Sphere, Box, Plane, Cylinder, Cone, Torus, VertexCloud,
Polyhedron (a convex OBJ, read relative to the scene file), TriangleMesh (an
OBJ read the same way; `center` and `density`) and TriangleMeshInline
primitives;
GravityForce and StokesDragForce;
RigidBody (enabled, position, rpy/quat/aangle, velocities,
InertiaFromPrimitive, CollisionGeometry); RCArticulatedBody with inline
links and joints (fixed, revolute, prismatic, spherical, universal, planar;
floating base, `translate`, limits, `restitution-coeff`, `q`, `qd`,
`q-tare`); TimeSteppingSimulator (DynamicBody, RecurrentForce,
ContactParameters, DisabledPair, min-step-size,
constraint-stabilization-max-iterations); the <DRIVER> block's step-size.

Compliant bodies (`compliant="true"` with the ContactParameters'
penalty-kp/kv), an articulated body's <Gears> and the simulator's
<ImplicitConstraint> of a top-level PlanarJoint or SphericalJoint between
free bodies compile and step as in the JAX package.

What the port does not run raises `NotImplementedError` naming it: a
Heightmap or HeightmapInline primitive when a body refers to it (an unused
one, e.g. a visualization-only shape, is ignored), an embedded SDF model, an
articulated body read from a URDF file;
`SceneBuilder.compile` refuses the geometry pairs the narrow phase does not
run (e.g. cylinder-sphere, or a mesh against a cylinder), naming the pair.
"""

from __future__ import annotations

import math
import os
import warnings
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from ..core import scene as sc
from ..dynamics import model as amdl

# primitive tags the port reads, and those the JAX reader accepts and the
# port's geometry does not run
_PRIMITIVES = ("Sphere", "Box", "Plane", "Cylinder", "Cone", "Torus",
               "VertexCloud", "Polyhedron", "TriangleMesh", "TriangleMeshInline")
_UNPORTED_PRIMITIVES = ("Heightmap", "HeightmapInline")


@dataclass
class DriverOptions:
    step_size: float = 0.001  # programs/driver.cpp:59 default


def _floats(s):
    return np.array(
        [float(x) for x in s.replace(",", " ").replace(";", " ").split()]
    )


def _rpy_quat(rpy):
    r, p, y = rpy
    hr, hp, hy = r / 2, p / 2, y / 2
    cr, sr = math.cos(hr), math.sin(hr)
    cp, sp = math.cos(hp), math.sin(hp)
    cy, sy = math.cos(hy), math.sin(hy)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def _aangle_quat(aa):
    axis = aa[:3]
    n = np.linalg.norm(axis)
    axis = axis / n if n > 0 else np.array([1.0, 0, 0])
    half = aa[3] / 2
    return np.concatenate([axis * math.sin(half), [math.cos(half)]])


def _pose_from_attrs(el, pos_key="position"):
    pos = np.zeros(3)
    quat = np.array([0.0, 0.0, 0.0, 1.0])
    if el.get(pos_key):
        pos = _floats(el.get(pos_key))
    if el.get("rpy"):
        quat = _rpy_quat(_floats(el.get("rpy")))
    elif el.get("quat"):
        q = _floats(el.get("quat"))
        quat = q / np.linalg.norm(q)
    elif el.get("aangle"):
        quat = _aangle_quat(_floats(el.get("aangle")))
    return pos, quat


@dataclass
class _Primitive:
    gtype: int
    params: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    mass: float = 0.0
    inertia: np.ndarray = None  # (3,3) about primitive COM, primitive frame
    verts: np.ndarray = None
    faces: np.ndarray = None    # (F, 3) triangle indices of a triangle mesh


def _resolve_path(fname, base_dir):
    if os.path.isabs(fname) or base_dir is None:
        return fname
    cand = os.path.join(base_dir, fname)
    return cand if os.path.exists(cand) else fname


def _parse_primitive(el, base_dir=None):
    """A `_Primitive`, or the tag name of a primitive the port does not run."""
    tag = el.tag
    if tag in _UNPORTED_PRIMITIVES:
        return tag
    pos, quat = _pose_from_attrs(el)
    mass_attr = el.get("mass")
    density = el.get("density")

    def mass_of(vol):
        return float(mass_attr) if mass_attr else (float(density) * vol if density else 0.0)

    if tag == "Sphere":
        r = float(el.get("radius", 1.0))
        m = mass_of(4.0 / 3.0 * math.pi * r ** 3)
        return _Primitive(sc.SPHERE, np.array([r]), pos, quat, m, sc.sphere_inertia(m, r))
    if tag == "Box":
        xl = float(el.get("xlen", 1.0))
        yl = float(el.get("ylen", 1.0))
        zl = float(el.get("zlen", 1.0))
        m = mass_of(xl * yl * zl)
        half = np.array([xl / 2, yl / 2, zl / 2])
        return _Primitive(
            sc.BOX, half, pos, quat, m, sc.box_inertia(m, *half), sc.box_vertices(*half)
        )
    if tag == "Plane":
        return _Primitive(sc.PLANE, np.array([0.0]), pos, quat)
    if tag == "VertexCloud":
        # extension tag (the JAX package's xmlwriter round-trip of POLYHEDRON)
        verts = _floats(el.get("vertices")).reshape(-1, 3)
        m = float(mass_attr) if mass_attr else 0.0
        return _Primitive(sc.POLYHEDRON, np.array([0.0]), pos, quat, m,
                          np.eye(3) * 1e-12, verts)
    if tag == "Cylinder":
        r = float(el.get("radius", 1.0))
        h = float(el.get("height", 1.0))
        m = mass_of(math.pi * r * r * h)
        return _Primitive(sc.CYLINDER, np.array([r, h]), pos, quat, m,
                          sc.cylinder_inertia(m, r, h))
    if tag == "Cone":
        # XMLReader::read_cone; axis local Y, apex +H/2, base radius R
        r = float(el.get("radius", 1.0))
        h = float(el.get("height", 1.0))
        m = mass_of(math.pi * r * r * h / 3.0)
        # ConePrimitive::calc_mass_properties
        iy = m * r * r / 3.0
        ix = 0.1 * m * h * h + 3.0 / 20.0 * m * r * r
        return _Primitive(sc.CONE, np.array([r, h]), pos, quat, m, np.diag([ix, iy, ix]))
    if tag == "Torus":
        R = float(el.get("major-radius", 1.0))
        r = float(el.get("minor-radius", 0.1))
        m = mass_of(2 * math.pi ** 2 * R * r * r)
        # about the symmetry axis z
        iz = m * (R ** 2 + 0.75 * r ** 2)
        ix = m * (0.5 * R ** 2 + 0.625 * r ** 2)
        return _Primitive(sc.TORUS, np.array([R, r]), pos, quat, m, np.diag([ix, ix, iz]))
    if tag == "Polyhedron":
        # XMLReader::read_polyhedron -> PolyhedralPrimitive (a convex
        # polyhedron from an OBJ, src/PolyhedralPrimitive.cpp), kept as its
        # convex vertex cloud
        from ..geometry import trimesh

        verts, faces = trimesh.load_obj(_resolve_path(el.get("filename"), base_dir))
        m = float(mass_attr) if mass_attr else 0.0
        inertia = np.eye(3) * 1e-12
        if m > 0 and len(faces):
            try:
                inertia = trimesh.mesh_inertia(m, verts, faces)[0]
            except ValueError:
                pass
        return _Primitive(sc.POLYHEDRON, np.array([0.0]), pos, quat, m,
                          inertia, verts)
    if tag == "TriangleMeshInline":
        # the JAX package's xmlwriter extension: a self-contained indexed mesh
        verts = _floats(el.get("vertices")).reshape(-1, 3)
        faces = np.array([int(t) for t in el.get("faces").split()],
                         np.int32).reshape(-1, 3)
        m = float(mass_attr) if mass_attr else 0.0
        from ..geometry import trimesh

        inertia = np.eye(3) * 1e-12
        if m > 0:
            try:
                inertia = trimesh.mesh_inertia(m, verts, faces)[0]
            except ValueError:
                pass
        return _Primitive(sc.TRIMESH, np.array([0.0]), pos, quat, m,
                          inertia, verts, faces)
    if tag == "TriangleMesh":
        # TriangleMeshPrimitive::load_from_xml's attributes: filename (an
        # OBJ), center (move the mesh onto its COM; default true),
        # src/TriangleMeshPrimitive.cpp:199
        from ..geometry import trimesh

        verts, faces = trimesh.load_obj(_resolve_path(el.get("filename"), base_dir))
        m = float(mass_attr) if mass_attr else 0.0
        inertia = np.eye(3) * 1e-12
        com = np.zeros(3)
        if len(faces):
            try:
                # max(m, 1): a mesh lighter than 1 kg gets the inertia of 1 kg,
                # as in the JAX package (ROADMAP §3, matched)
                inertia, com, vol = trimesh.mesh_inertia(max(m, 1.0), verts, faces)
                if m <= 0 and density:
                    m = float(density) * vol
                    inertia, com, vol = trimesh.mesh_inertia(m, verts, faces)
            except ValueError:
                pass
        if el.get("center", "true").lower() in ("true", "1"):
            verts = verts - com
        return _Primitive(sc.TRIMESH, np.array([0.0]), pos, quat, m,
                          inertia, verts, faces)
    raise ValueError(f"unsupported primitive tag {tag}")


def _prim(prims, pid) -> _Primitive:
    p = prims[pid]
    if isinstance(p, str):
        raise NotImplementedError(
            f"the <{p}> primitive '{pid}' is not ported yet (ported: "
            f"{', '.join(_PRIMITIVES)})")
    return p


def _quat_to_R(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def load(path: str, post_build=None, device="cuda", dtype=None):
    """Read a Moby XML scene file -> (Scene, State of batch 1,
    DriverOptions), compiled on `device` (the card unless "cpu" is asked
    for) in `dtype` (default: float32 on the card, float64 on the CPU).

    `post_build(builder)`: optional hook invoked before compilation — the
    Python equivalent of the reference's dlopen'd `init` plugins
    (programs/driver.cpp:307-352).
    """
    root = ET.parse(path).getroot()
    base_dir = os.path.dirname(os.path.abspath(path))
    opts = DriverOptions()

    driver = root.find("DRIVER")
    if driver is not None and driver.get("step-size"):
        opts.step_size = float(driver.get("step-size"))

    moby = root.find("MOBY")
    if moby is None:
        moby = root

    prims = {}
    gravity = np.zeros(3)
    gravity_ids = set()
    drag_forces: dict[str, tuple] = {}
    bodies_xml = {}
    abs_xml = {}
    loose_joints = {}
    sim_el = None

    for el in moby:
        if el.tag in _PRIMITIVES + _UNPORTED_PRIMITIVES:
            prims[el.get("id")] = _parse_primitive(el, base_dir)
        elif el.tag == "TetraMesh":
            # registered but inert in the reference too: XMLReader::
            # read_tetramesh's body is commented out (src/XMLReader.cpp:458)
            warnings.warn("TetraMesh tag is not constructible (matches the "
                          "reference's disabled read_tetramesh)")
        elif el.tag == "GravityForce":
            gravity_ids.add(el.get("id"))
            gravity = _floats(el.get("accel", "0 0 0"))
        elif el.tag == "StokesDragForce":
            drag_forces[el.get("id")] = (
                float(el.get("drag-b", 0.0)),
                float(el.get("drag-b-ang", 0.0)),
            )
        elif el.tag == "RigidBody":
            bodies_xml[el.get("id")] = el
        elif el.tag == "RCArticulatedBody":
            abs_xml[el.get("id")] = el
        elif el.tag in _JOINT_TAGS:
            # top-level joints between free rigid bodies become
            # simulator-level implicit constraints when referenced by an
            # <ImplicitConstraint joint-id=...>
            loose_joints[el.get("id")] = el
        elif el.tag == "SDF":
            raise NotImplementedError(
                "embedded <SDF> models are not ported yet")
        elif el.tag in ("TimeSteppingSimulator", "Simulator", "EventDrivenSimulator"):
            sim_el = el

    if sim_el is None:
        raise ValueError("no simulator element found")

    b = sc.SceneBuilder()

    # which bodies the simulator includes, in document order
    body_ids = [
        c.get("dynamic-body-id") for c in sim_el if c.tag == "DynamicBody"
    ]
    # recurrent forces: gravity applies if referenced
    if any(c.tag == "RecurrentForce" and c.get("recurrent-force-id") in gravity_ids
           for c in sim_el):
        b.set_gravity(gravity)
    # Stokes drag applies to every body when referenced as a recurrent force
    drag = [
        drag_forces[c.get("recurrent-force-id")]
        for c in sim_el
        if c.tag == "RecurrentForce"
        and c.get("recurrent-force-id") in drag_forces
    ]
    if drag:
        bl = sum(d[0] for d in drag)
        ba = sum(d[1] for d in drag)
        for bid in body_ids:
            b.drag_lin[bid] = bl
            b.drag_ang[bid] = ba

    for bid in body_ids:
        el = bodies_xml.get(bid)
        if el is None:
            if bid in abs_xml:
                _build_articulated(b, abs_xml[bid], prims)
                continue
            raise ValueError(f"body {bid} not found")
        pos, quat = _pose_from_attrs(el)
        enabled = el.get("enabled", "true").lower() != "false"
        compliant = el.get("compliant", "false").lower() == "true"
        lv = _floats(el.get("linear-velocity", "0 0 0"))
        av = _floats(el.get("angular-velocity", "0 0 0"))

        # accumulate inertia from InertiaFromPrimitive children
        mass = float(el.get("mass", 0.0))
        inertia = np.zeros((3, 3))
        if el.get("inertia"):
            inertia = _floats(el.get("inertia")).reshape(3, 3)
        for ch in el.findall("InertiaFromPrimitive"):
            p = _prim(prims, ch.get("primitive-id"))
            rel_pos = np.zeros(3)
            rel_quat = np.array([0.0, 0, 0, 1.0])
            if ch.get("relative-origin"):
                rel_pos = _floats(ch.get("relative-origin"))
            if ch.get("relative-rpy"):
                rel_quat = _rpy_quat(_floats(ch.get("relative-rpy")))
            # primitive inertia about its own COM, transformed into body frame
            R = _quat_to_R(rel_quat) @ _quat_to_R(p.quat)
            off = rel_pos + p.pos
            J = R @ p.inertia @ R.T
            # parallel axis to the body origin
            J = J + p.mass * (np.dot(off, off) * np.eye(3) - np.outer(off, off))
            inertia = inertia + J
            mass += p.mass

        b.add_body(
            bid,
            mass=mass,
            inertia=inertia if np.any(inertia) else np.eye(3),
            pos=pos,
            quat=quat,
            lin_vel=lv,
            ang_vel=av,
            enabled=enabled,
            compliant=compliant,
        )

        for ch in el.findall("CollisionGeometry"):
            if not ch.get("primitive-id"):
                # geometry provided by a collision-detection plugin
                continue
            p = _prim(prims, ch.get("primitive-id"))
            gpos, gquat = _pose_from_attrs(ch, pos_key="relative-origin")
            # compose geometry-relative pose with the primitive's own pose
            Rg = _quat_to_R(gquat)
            b.add_geom(bid, p.gtype, p.params, pos=gpos + Rg @ p.pos,
                       quat=_quat_mul(gquat, p.quat), verts=p.verts, faces=p.faces)

    for c in sim_el:
        if c.tag == "ContactParameters":
            cp = sc.ContactParams(
                epsilon=float(c.get("epsilon", 0.0)),
                mu_coulomb=_parse_mu(c.get("mu-coulomb", "0")),
                mu_viscous=float(c.get("mu-viscous", 0.0)),
                nk=_parse_nk(c.get("friction-cone-edges", "4")),
                compliance=float(c.get("compliance", 0.0)),
                penalty_kp=float(c.get("penalty-kp", 0.0)),
                penalty_kv=float(c.get("penalty-kv", 0.0)),
            )
            b.set_contact_params(c.get("object1-id"), c.get("object2-id"), cp)
        elif c.tag == "DisabledPair":
            b.disabled_pairs.add(
                tuple(sorted((c.get("object1-id"), c.get("object2-id"))))
            )
        elif c.tag == "ImplicitConstraint":
            jel = loose_joints.get(c.get("joint-id"))
            if jel is None:
                raise ValueError(
                    f"ImplicitConstraint references unknown joint "
                    f"{c.get('joint-id')}")
            inb = jel.get("inboard-link-id")
            outb = jel.get("outboard-link-id")

            def body_of(name):
                return next(bd for bd in b.bodies if bd.name == name)

            if jel.tag == "PlanarJoint":
                # the normal is given in world coordinates at load: express
                # it in the inboard body's frame
                Rb = _quat_to_R(body_of(inb).quat)
                b.add_planar_constraint(
                    outb, inb, Rb.T @ _floats(jel.get("normal", "0 1 0")))
            elif jel.tag == "SphericalJoint":
                loc = _floats(jel.get("location", "0 0 0"))

                def local(name):
                    bd = body_of(name)
                    return _quat_to_R(bd.quat).T @ (loc - bd.pos)

                b.add_point_constraint(outb, local(outb), inb, local(inb))
            else:
                raise ValueError(
                    f"ImplicitConstraint joint type {jel.tag} between free "
                    f"bodies is not supported")

    if sim_el.get("min-step-size"):
        b.min_step_size = float(sim_el.get("min-step-size"))
    if sim_el.get("constraint-stabilization-max-iterations") is not None:
        b.stab_max_iters = min(
            8, int(float(sim_el.get("constraint-stabilization-max-iterations")))
        )

    if post_build is not None:
        post_build(b)

    scene, state = b.compile(device=device, dtype=dtype)
    return scene, state, opts


_JOINT_TAGS = {
    "RevoluteJoint": amdl.REVOLUTE,
    "PrismaticJoint": amdl.PRISMATIC,
    "SphericalJoint": amdl.SPHERICAL,
    "UniversalJoint": amdl.UNIVERSAL,
    "FixedJoint": amdl.FIXED,
    "PlanarJoint": amdl.PLANAR,
}


def _build_articulated(b, el, prims):
    """Build an RCArticulatedBody from Moby XML inline links and joints
    (reference src/RCArticulatedBody.cpp load_from_xml).

    Inline convention: link poses and joint locations/axes are given in world
    coordinates at the configured joint coordinates `q`. Each link's frame is
    re-rooted at its inboard joint (origin = joint location, orientation =
    link orientation) and the fixed tree transform Xt solved from
    XJ(q0) ∘ Xt = X_configured.
    """
    ab_name = el.get("id")
    floating = el.get("floating-base", "false").lower() == "true"
    if el.get("urdf-filename"):
        raise NotImplementedError(
            f"articulated body '{ab_name}' from a URDF file: the URDF reader "
            "is not ported yet")

    translate = np.zeros(3)
    if el.get("translate"):
        translate = _floats(el.get("translate"))

    # parse links
    links = {}
    link_order = []
    for ch in el.findall("RigidBody"):
        lid = ch.get("id")
        pos, quat = _pose_from_attrs(ch)
        pos = pos + translate
        # explicit mass/inertia (about COM, link axes) take precedence;
        # otherwise accumulate from InertiaFromPrimitive children
        mass = float(ch.get("mass", 0.0))
        inertia = np.zeros((3, 3))
        com_local = np.zeros(3)
        if ch.get("inertia"):
            inertia = _floats(ch.get("inertia")).reshape(3, 3)
        if ch.get("com"):
            com_local = _floats(ch.get("com"))
        for ip in ch.findall("InertiaFromPrimitive"):
            p = _prim(prims, ip.get("primitive-id"))
            R = _quat_to_R(p.quat)
            J = R @ p.inertia @ R.T
            off = p.pos
            J = J + p.mass * (np.dot(off, off) * np.eye(3) - np.outer(off, off))
            inertia = inertia + J
            mass += p.mass
        geoms = []
        for cg in ch.findall("CollisionGeometry"):
            pid = cg.get("primitive-id")
            if pid:
                p = _prim(prims, pid)
                gpos, gquat = _pose_from_attrs(cg, pos_key="relative-origin")
                Rg = _quat_to_R(gquat)
                geoms.append(
                    (p.gtype, p.params, gpos + Rg @ p.pos, _quat_mul(gquat, p.quat), p.verts)
                )
        links[lid] = dict(
            pos=pos, quat=quat, mass=mass, inertia=inertia, geoms=geoms,
            com_local=com_local,
            lv=_floats(ch.get("linear-velocity", "0 0 0")),
            av=_floats(ch.get("angular-velocity", "0 0 0")),
        )
        link_order.append(lid)

    def opt(ch, key):
        return _floats(ch.get(key)) if ch.get(key) else None

    # parse joints
    joints = []
    for ch in el:
        if ch.tag in _JOINT_TAGS:
            joints.append(
                dict(
                    jtype=_JOINT_TAGS[ch.tag],
                    location=_floats(ch.get("location", "0 0 0")) + translate,
                    axis=opt(ch, "axis") if ch.get("axis") else np.array([1.0, 0, 0]),
                    inboard=ch.get("inboard-link-id"),
                    outboard=ch.get("outboard-link-id"),
                    q=opt(ch, "q"),
                    # q-tare: constant offset added inside the joint
                    # transform so reported q keeps the user's zero
                    # (src/Joint.cpp:239-247)
                    tare=opt(ch, "q-tare"),
                    qd=opt(ch, "qd"),
                    lo=opt(ch, "lower-limits"),
                    hi=opt(ch, "upper-limits"),
                    restitution=float(ch.get("restitution-coeff", 0.0)),
                )
            )

    build_ab_from_world(b, ab_name, links, joints, floating, link_order)

    # gear couplings (Moby::Gears: +1 on the inboard link's joint coordinate,
    # -ratio on the outboard link's — src/Gears.cpp:64-96)
    for ch in el:
        if ch.tag == "Gears":
            b.add_gear_constraint(
                ab_name,
                ch.get("inboard-link-id"),
                ch.get("outboard-link-id"),
                float(ch.get("gear-ratio", 1.0)),
            )


def build_ab_from_world(b, ab_name, links, joints, floating, link_order):
    """Build an articulated body from world-posed links + world-located
    joints.

    links: name -> dict(pos, quat, mass, inertia (about COM, link axes),
           com_local (optional), geoms, lv, av)
    joints: list of dict(jtype, location (world), axis (world), inboard,
           outboard, q, qd, lo, hi, restitution)
    """
    # base = link that is never an outboard
    outboards = {j["outboard"] for j in joints}
    base_candidates = [l for l in link_order if l not in outboards]
    if len(base_candidates) != 1:
        raise ValueError(f"ambiguous base for {ab_name}: {base_candidates}")
    base = base_candidates[0]

    in_joints = {j["outboard"]: j for j in joints}
    kids = {}
    for j in joints:
        kids.setdefault(j["inboard"], []).append(j["outboard"])

    link_defs = []
    parents = []
    names = []
    name_to_idx = {}
    q0_list = []
    qd0_list = []
    # model frame per link: (R_m, p_m)
    model_frames = {}

    def base_linkdef():
        lk = links[base]
        Rb = _quat_to_R(lk["quat"])
        if floating:
            jd = amdl.JointDef(
                jtype=amdl.FLOATING, Xt_E=np.eye(3), Xt_r=np.zeros(3), name="base"
            )
            q0_list.append(np.concatenate([lk["pos"], lk["quat"]]))
            qd0_list.append(
                np.concatenate([Rb.T @ lk["av"], Rb.T @ lk["lv"]])
            )
        else:
            jd = amdl.JointDef(
                jtype=amdl.FIXED, Xt_E=Rb.T, Xt_r=lk["pos"], name="base"
            )
        model_frames[base] = (Rb, lk["pos"])
        return amdl.LinkDef(
            name=base, mass=lk["mass"],
            com=lk.get("com_local", np.zeros(3)),
            inertia_com=lk["inertia"] if np.any(lk["inertia"]) else np.eye(3) * 1e-12,
            joint=jd,
        )

    link_defs.append(base_linkdef())
    parents.append(-1)
    names.append(base)
    name_to_idx[base] = 0

    def joint_mats(jtype, axis_j, q0):
        """Numpy (EJ, rJ) of the joint transform at coordinates q0."""
        if jtype == amdl.REVOLUTE:
            th = q0[0]
            K = np.array(
                [[0, -axis_j[2], axis_j[1]], [axis_j[2], 0, -axis_j[0]], [-axis_j[1], axis_j[0], 0]]
            )
            R = np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * (K @ K)
            return R.T, np.zeros(3)
        if jtype == amdl.PRISMATIC:
            return np.eye(3), axis_j * q0[0]
        if jtype == amdl.FIXED:
            return np.eye(3), np.zeros(3)
        if jtype == amdl.SPHERICAL:
            return _quat_to_R(q0[:4]).T, np.zeros(3)
        if not np.any(np.asarray(q0, float)):
            return np.eye(3), np.zeros(3)
        raise ValueError(f"inline nonzero-q baking unimplemented for joint type {jtype}")

    def add_subtree(lname):
        for child in kids.get(lname, []):
            j = in_joints[child]
            lk = links[child]
            Rp, pp = model_frames[lname]
            Rc = _quat_to_R(lk["quat"])
            L = j["location"]
            nqj = amdl.NQ[j["jtype"]]
            q0 = j["q"] if j["q"] is not None else np.zeros(max(nqj, 1))
            if j["jtype"] == amdl.SPHERICAL and j["q"] is None:
                q0 = np.array([0.0, 0, 0, 1.0])
            # q-tare shifts the joint transform's evaluation point: the
            # configured world poses correspond to q0 + tare, while the
            # runtime state keeps reporting q starting at q0
            tare = j.get("tare")
            q0_eff = (
                q0 if tare is None
                else np.asarray(q0, float)
                + np.asarray(tare, float)[: len(np.atleast_1d(q0))]
            )
            a_j = Rc.T @ (j["axis"] / max(np.linalg.norm(j["axis"]), 1e-15))
            a2 = j.get("axis2")
            a2_j = (
                None if a2 is None
                else Rc.T @ (a2 / max(np.linalg.norm(a2), 1e-15))
            )

            E_conf = Rc.T @ Rp
            r_conf = Rp.T @ (L - pp)
            EJ, rJ = joint_mats(j["jtype"], a_j, q0_eff)
            Et = EJ.T @ E_conf
            rt = r_conf - Et.T @ rJ

            jd = amdl.JointDef(
                jtype=j["jtype"],
                Xt_E=Et,
                Xt_r=rt,
                axis=a_j,
                axis2=a2_j,
                lo=j["lo"],
                hi=j["hi"],
                restitution=j["restitution"],
                tare=None if tare is None else np.asarray(tare, float),
                name=child,
            )
            com_world = lk["pos"] + Rc @ lk.get("com_local", np.zeros(3))
            com = Rc.T @ (com_world - L)
            link_defs.append(
                amdl.LinkDef(
                    name=child, mass=lk["mass"], com=com,
                    inertia_com=lk["inertia"] if np.any(lk["inertia"]) else np.eye(3) * 1e-12,
                    joint=jd,
                )
            )
            parents.append(name_to_idx[lname])
            names.append(child)
            name_to_idx[child] = len(link_defs) - 1
            model_frames[child] = (Rc, L)
            if nqj:
                q0_list.append(np.asarray(q0, float)[:nqj])
                qd = j["qd"] if j["qd"] is not None else np.zeros(amdl.NV[j["jtype"]])
                qd0_list.append(np.asarray(qd, float))
            add_subtree(child)

    add_subtree(base)

    model = amdl.ArticulatedModel(link_defs, floating=floating)
    model.set_parents(parents)
    q0 = np.concatenate(q0_list) if q0_list else np.zeros(0)
    qd0 = np.concatenate(qd0_list) if qd0_list else np.zeros(0)
    b.add_articulated(ab_name, model, q0=q0, qd0=qd0, link_names=names)

    # geometries: local pose in the model frame (origin at joint location)
    for lname in names:
        lk = links[lname]
        Rm, pm = model_frames[lname]
        off = Rm.T @ (lk["pos"] - pm)
        for (gtype, params, gpos, gquat, verts) in lk["geoms"]:
            b.add_geom(
                f"{ab_name}/{lname}", gtype, params,
                pos=off + gpos, quat=gquat, verts=verts,
            )


def _parse_mu(s):
    s = s.strip().lower()
    if s in ("inf", "infinity"):
        return 1e8
    return float(s)


def _parse_nk(s):
    """friction-cone-edges; "inf"/"UINF" = true cone (reference contact_NK ==
    UINF selects the NQP model, ImpactConstraintHandler.cpp:629-640)."""
    s = s.strip().lower()
    if s in ("inf", "infinity", "uinf"):
        return 0
    v = int(float(s))
    return v if v > 0 else 0


def _quat_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )
