"""PyTorch port: `moby_tpu_torch.core.scene` against `moby_tpu.core.scene`.

The port's own `SceneBuilder.compile()` must give the same arrays and statics
as the JAX package's for the benchmark scenes (equal, not close: both run the
same host-side numpy), and `scene_from_arrays`/`state_from_arrays` must carry
a compiled JAX scene across unchanged.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.dynamics import model as tmdl
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    assert_same_compiled, assert_same_fields, assert_same_hulls, build_ballpush,
    build_box_on_box, build_box_on_plane, build_compliant_ball, build_convex,
    build_curved, build_gear_pendulum, build_octa_on_box, build_planar_box,
    build_mesh_kinds, build_sphere_chain, build_stack, jax_fields,
    pendulum_model, torch_scene_state,
)

SCENES = {
    "stack_nk16": lambda sc: build_stack(sc, nk=16),
    "stack_nk4": lambda sc: build_stack(sc, nk=4),
    "ballpush": build_ballpush,
    "box_on_plane": build_box_on_plane,
    "box_on_box": build_box_on_box,
    "box_on_box_capped": lambda sc: build_box_on_box(sc, max_slots=6),
    "curved": build_curved,
    "convex": build_convex,
    "octa_on_box": build_octa_on_box,
}


@pytest.mark.parametrize("name", list(SCENES))
def test_compile_matches_jax(name):
    jscene, jstate = SCENES[name](jsc).compile()
    tscene, tstate = SCENES[name](tsc).compile(device="cpu")
    assert tscene.dtype == torch.float64 and tstate.pos.dtype == torch.float64
    jf = jax_fields(jscene)
    assert_same_fields(tscene, jf, tsc._SCENE_ARRAYS + tsc._SCENE_STATICS
                 + ("body_names",))
    assert_same_hulls(tscene, jf)
    assert (tscene.n_vars, tscene.n_ineq, tscene.n_lcp) == (
        jscene.n_vars, jscene.n_ineq, jscene.n_lcp)
    assert set(tscene.kind_groups) == set(jscene.kind_groups)
    for key, grp in jscene.kind_groups.items():
        for f in ("pairs", "slots"):
            np.testing.assert_array_equal(tscene.kind_groups[key][f], grp[f])
        assert tscene.kind_groups[key]["nslots"] == grp["nslots"]
    assert_same_fields(tstate, jax_fields(jstate), tsc._STATE_ARRAYS)
    assert tstate.batch == 1


def test_stack_sizes():
    scene, _ = build_stack(tsc, nk=16).compile(device="cpu")
    assert (scene.nb, scene.ngc, scene.n_pairs, scene.n_contacts) == (4, 24, 6, 6)
    assert scene.n_friction_rows == 30 and scene.n_lcp == 66


@pytest.mark.parametrize("name", ["stack_nk16", "box_on_plane", "convex"])
def test_from_arrays_round_trip(name):
    jscene, jstate = SCENES[name](jsc).compile()
    tscene, tstate = torch_scene_state(jscene, jstate)
    assert_same_fields(tscene, jax_fields(jscene), tsc._SCENE_ARRAYS + tsc._SCENE_STATICS)
    assert_same_hulls(tscene, jax_fields(jscene))
    assert_same_fields(tstate, jax_fields(jstate), tsc._STATE_ARRAYS)
    # float32 on request; the state follows
    s32, st32 = torch_scene_state(jscene, jstate, torch.float32)
    assert s32.mass.dtype == torch.float32 and st32.pos.dtype == torch.float32
    assert s32.slot_pair.dtype == torch.int64 and s32.enabled.dtype == torch.bool


def test_state_expand_replace_to():
    _, st = build_stack(tsc, nk=4).compile(device="cpu")
    st5 = st.expand(5)
    assert st5.batch == 5 and st5.zlast.shape == (5, st.zlast.shape[1])
    st5.pos[0, 0, 0] = 7.0                      # expanded copies are independent
    assert float(st5.pos[1, 0, 0]) == 0.0 and float(st.pos[0, 0, 0]) == 0.0
    st2 = st5.replace(time=st5.time + 1.0)
    assert float(st2.time[0]) == 1.0 and float(st5.time[0]) == 0.0
    assert st5.to("cpu").pos.device.type == "cpu"
    with pytest.raises(dataclasses.FrozenInstanceError):
        st5.pos = st5.pos


def test_compile_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="cuda"):
        build_stack(tsc).compile()


def test_curved_and_convex_tables():
    """The new geometries' compiled tables: slots per kind (4 for the curved
    kinds, 8 for convex-convex, one per vertex against the plane), the hull
    directions of an octahedron (4 face normals and 6 edge directions up to
    sign) and a box (3 normals; edges and the face diagonals of its hull
    triangles), the bounding radii."""
    scene, _ = build_curved(tsc).compile(device="cpu")
    assert {k: n for k, n in scene.kind_groups} == {4: 4, 10: 4, 5: 4}
    np.testing.assert_allclose(scene.host["geom_rmax"][1:],
                               [np.hypot(0.5, 0.5), np.hypot(0.6, 0.6), 1.25])
    assert scene.n_contacts == 12 and scene.host["geom_nhn"].sum() == 0
    scene, _ = build_octa_on_box(tsc).compile(device="cpu")
    assert list(scene.kind_groups) == [(9, 8)]
    assert list(scene.host["geom_nhn"]) == [4, 3]
    assert scene.host["geom_nhe"][0] == 6 and scene.host["geom_nhe"][1] > 3
    assert scene.host["geom_nfaces"][0] == 8       # the octahedron's hull
    n = scene.host["geom_hull_normals"][0, :4]
    np.testing.assert_allclose(np.abs(n), 1 / np.sqrt(3.0), atol=1e-12)


def test_trimesh_tables_match_jax():
    """A scene of every mesh kind (3, 11, 12 and 13, mesh-polyhedron in both
    orders) compiles to the JAX package's arrays, statics and kind groups:
    the face table (`geom_faces`, `geom_nfaces`: a mesh's own triangles, a
    polyhedron's hull triangles in its own vertex order), `geom_nverts`,
    `geom_rmax`, `slot_rmax`, and the slot counts (4, min(vmax, 16) + 8,
    8); a mesh without faces or without vertices is refused as there."""
    jscene, jstate = build_mesh_kinds(jsc).compile()
    tscene, tstate = build_mesh_kinds(tsc).compile(device="cpu")
    assert_same_compiled(tscene, tstate, jscene, jstate)
    for k in ("geom_faces", "geom_nfaces", "geom_nverts", "geom_rmax", "slot_rmax"):
        np.testing.assert_array_equal(tscene.host[k], np.asarray(getattr(jscene, k)), err_msg=k)
    assert {k: g["nslots"] for k, g in tscene.kind_groups.items()} == {
        (3, 16): 16, (11, 4): 4, (12, 24): 24, (13, 8): 8}
    assert int(tscene.host["geom_nfaces"].max()) == 80      # the icosphere
    carried, _ = torch_scene_state(jscene, jstate)
    np.testing.assert_array_equal(carried.host["geom_faces"], tscene.host["geom_faces"])
    for sc_ in (jsc, tsc):
        b = sc_.SceneBuilder()
        b.add_body("m", mass=1.0)
        with pytest.raises(ValueError, match="TRIMESH geometry needs verts and faces"):
            b.add_geom("m", sc_.TRIMESH, [0.0], verts=np.eye(3))
        with pytest.raises(ValueError, match="TRIMESH geometry needs verts and faces"):
            b.add_geom("m", sc_.TRIMESH, [0.0], faces=np.array([[0, 1, 2]]))


def _unported_features():
    def articulated(b):
        # articulated bodies run; a link's cylinder meets the stack's
        # spheres in the support-pair kind, refused by the pair's name
        b.add_articulated("arm", pendulum_model(tmdl))
        b.add_geom("arm/rod", tsc.CYLINDER, [0.1, 1.0])

    def pool(b):
        b.set_pair_pool(tsc.SPHERE, tsc.SPHERE, 4)

    def plugin(b):
        b.add_custom_pair("sph1", "sph2", lambda *a: None, 1)

    def heightmap(b):
        b.add_geom("sph1", tsc.HEIGHTMAP, [1.0, 1.0], heights=np.zeros((2, 2)))

    def trimesh_cylinder(b):
        # a mesh against a curved solid: the support kind 400 + CYLINDER
        b.add_body("mesh", mass=1.0, pos=np.array([5.0, 0.0, 1.0]))
        b.add_geom("mesh", tsc.TRIMESH, [0.0], verts=np.eye(3),
                   faces=np.array([[0, 1, 2]]))
        b.add_body("can", mass=1.0, pos=np.array([5.0, 0.0, 3.0]))
        b.add_geom("can", tsc.CYLINDER, [0.5, 1.0])
        for n in ("sph1", "sph2", "sph3", "ground"):
            for m in ("mesh", "can"):
                b.disabled_pairs.add(tuple(sorted((n, m))))

    def cylinder(b):
        b.add_geom("sph1", tsc.CYLINDER, [0.5, 1.0])

    def torus(b):
        b.add_geom("sph1", tsc.TORUS, [1.0, 0.2])

    def polyhedron(b):
        b.add_geom("sph1", tsc.POLYHEDRON, [0.0], verts=np.eye(3) - 0.25)

    def trimesh_heightmap(b):
        # a mesh against a heightmap: kind 8
        b.add_body("mesh", mass=1.0, pos=np.array([5.0, 0.0, 1.0]))
        b.add_geom("mesh", tsc.TRIMESH, [0.0], verts=np.eye(3),
                   faces=np.array([[0, 1, 2]]))
        b.add_body("terrain", enabled=False)
        b.add_geom("terrain", tsc.HEIGHTMAP, [1.0, 1.0], heights=np.zeros((2, 2)))
        for n in ("sph1", "sph2", "sph3", "ground"):
            for m in ("mesh", "terrain"):
                b.disabled_pairs.add(tuple(sorted((n, m))))

    def heightmap_alone(b):
        b.add_body("terrain", enabled=False)
        b.add_geom("terrain", tsc.HEIGHTMAP, [1.0, 1.0], heights=np.zeros((2, 2)))
        for n in ("sph1", "sph2", "sph3"):
            b.disabled_pairs.add(tuple(sorted((n, "terrain"))))

    return {f.__name__: f for f in (
        articulated, pool, plugin, heightmap, trimesh_cylinder, cylinder, torus,
        polyhedron, trimesh_heightmap, heightmap_alone)}


# what each refusal names: the pair (with its kind) where a pair reaches a
# kind the narrow phase does not run, else the feature or the geometry
_REFUSAL_NAMES = {
    "articulated": r"kind 103 \(SPHERE-CYLINDER support pair\) of the pair SPHERE vs CYLINDER",
    "pool": "pair pooling",
    "plugin": "plugin contact kernels",
    "heightmap": r"kind 7 \(sphere-heightmap\) of the pair SPHERE vs HEIGHTMAP",
    "trimesh_cylinder": r"kind 403 \(trimesh-CYLINDER support pair\) of the pair TRIMESH vs CYLINDER",
    "cylinder": r"kind 103 \(SPHERE-CYLINDER support pair\) of the pair SPHERE vs CYLINDER",
    "torus": r"kind 105 \(SPHERE-TORUS support pair\) of the pair SPHERE vs TORUS",
    "polyhedron": r"kind 107 \(SPHERE-POLYHEDRON support pair\) of the pair SPHERE vs POLYHEDRON",
    "trimesh_heightmap": r"kind 8 \(vertex solid-heightmap\) of the pair TRIMESH vs HEIGHTMAP",
    "heightmap_alone": r"HEIGHTMAP geometry \(body 'terrain'\)",
}


@pytest.mark.parametrize("feature", list(_unported_features()))
def test_unported_features_raise_at_compile(feature):
    b = build_stack(tsc, nk=4)
    _unported_features()[feature](b)
    with pytest.raises(NotImplementedError, match="not ported") as err:
        b.compile(device="cpu")
    assert re.search(_REFUSAL_NAMES[feature], str(err.value)), str(err.value)


MODEL_SCENES = {
    "gear": build_gear_pendulum,
    "point": lambda sc: build_sphere_chain(sc, n=3),
    "planar": build_planar_box,
    "compliant": lambda sc: build_compliant_ball(sc),
}


@pytest.mark.parametrize("name", list(MODEL_SCENES))
def test_contact_models_compile_matches_jax(name):
    """Gear, point and planar constraints and compliant bodies, refused
    before the port ran them, compile to the JAX package's arrays, statics
    and bilateral records, from the port's `SceneBuilder` and carried across."""
    jscene, jstate = MODEL_SCENES[name](jsc).compile()
    tscene, tstate = MODEL_SCENES[name](tsc).compile(device="cpu")
    assert_same_compiled(tscene, tstate, jscene, jstate)
    carried, _ = torch_scene_state(jscene, jstate)
    for ts in (tscene, carried):
        assert len(ts.bilaterals) == len(jscene.bilaterals)
        for tb, jb in zip(ts.bilaterals, jscene.bilaterals):
            for f in dataclasses.fields(tb):
                np.testing.assert_array_equal(
                    np.asarray(getattr(tb, f.name)), np.asarray(getattr(jb, f.name)),
                    err_msg=f.name)
    if name == "compliant":
        assert tscene.has_compliant and not tscene.use_noslip
        assert bool(tscene.slot_compliant.all())
    else:
        assert len(tscene.bilaterals) == {"gear": 1, "point": 3, "planar": 1}[name]
