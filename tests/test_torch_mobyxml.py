"""PyTorch port: the Moby XML loader `moby_tpu_torch.io.mobyxml` against
`moby_tpu.io.mobyxml`, and the articulated scenes built by both packages'
`SceneBuilder`s, float64 on the CPU.

Both in-repo scenes and the articulated test scenes compile to the same
arrays (equal, not close); a compiled JAX scene carried across with
`scene_from_arrays` equals the port's own compile; what the port does not
run raises `NotImplementedError` naming it; the curved and convex
primitive tags (with a Polyhedron's OBJ) and the mesh tags load to the JAX
loader's arrays;
loading and stepping a scene imports neither JAX nor Triton.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from moby_tpu.core import scene as jsc
from moby_tpu.io import mobyxml as jxml
from moby_tpu_torch.core import scene as tsc
from moby_tpu_torch.io import mobyxml as txml
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import (
    SITTING_BOX_XML, TABLE_XML, assert_same_compiled, build_limited_pendulum,
    build_pendulum_ball, t2n, torch_scene_state,
)

REPO = pathlib.Path(__file__).parents[1]


@pytest.mark.parametrize("path", [TABLE_XML, SITTING_BOX_XML],
                         ids=["table", "sitting_box"])
def test_scene_loads_like_jax(path):
    jscene, jstate, jopts = jxml.load(str(REPO / path))
    tscene, tstate, topts = txml.load(str(REPO / path), device="cpu")
    assert tscene.dtype == torch.float64
    assert topts.step_size == jopts.step_size
    assert_same_compiled(tscene, tstate, jscene, jstate)
    # the compiled JAX scene carried across equals the port's own load
    cscene, cstate = torch_scene_state(jscene, jstate)
    assert_same_compiled(cscene, cstate, jscene, jstate)


def test_table_layout():
    """The table: the ground, one floating base with four fixed legs; 5 boxes
    x 8 plane-generic vertex slots; no limits; every contact mu = inf."""
    scene, st, opts = txml.load(str(REPO / TABLE_XML), device="cpu")
    assert (scene.nb, scene.nq_art, scene.nv_art, scene.ngc) == (1, 7, 6, 12)
    assert (scene.n_contacts, scene.n_limits, scene.n_lcp) == (40, 0, 320)
    assert scene.use_noslip and not scene.mixed_models
    assert opts.step_size == 0.1
    np.testing.assert_array_equal(st.q_art[0].numpy(), [0, 0, 1.05, 0, 0, 0, 1])
    np.testing.assert_array_equal(st.qd_art[0].numpy(), [0, 0, 1, 0, 0, 0])
    s32, st32, _ = txml.load(str(REPO / TABLE_XML), device="cpu",
                             dtype=torch.float32)
    assert s32.dtype == torch.float32 and st32.q_art.dtype == torch.float32


@pytest.mark.parametrize("builder", [build_limited_pendulum, build_pendulum_ball],
                         ids=["limited_pendulum", "pendulum_ball"])
def test_builders_compile_like_jax(builder):
    jscene, jstate = builder(jsc).compile()
    tscene, tstate = builder(tsc).compile(device="cpu")
    assert_same_compiled(tscene, tstate, jscene, jstate)
    cscene, cstate = torch_scene_state(jscene, jstate)
    assert_same_compiled(cscene, cstate, jscene, jstate)


_CYLINDER_SCENE = """<XML><MOBY>
  <Cylinder id="c1" radius="0.5" height="1" density="1.0" />
  <Plane id="p" />
  <GravityForce id="g" accel="0 -9.81 0" />
  <RigidBody id="can" position="0 1 0">
    {inertia}
    <CollisionGeometry primitive-id="{geom}" />
  </RigidBody>
  <RigidBody id="ground" enabled="false"><CollisionGeometry primitive-id="p" /></RigidBody>
  <TimeSteppingSimulator>
    <DynamicBody dynamic-body-id="can" /><DynamicBody dynamic-body-id="ground" />
    <RecurrentForce recurrent-force-id="g" />
  </TimeSteppingSimulator>
</MOBY></XML>"""

_UNPORTED_TAGS = {
    "HeightmapInline": '<HeightmapInline id="c1" rows="2" cols="2" heights="0 0 0 0" />',
    "Heightmap": '<Heightmap id="c1" filename="terrain.txt" width="2" depth="2" />',
}


def test_unported_primitive_raises_naming_it(tmp_path):
    """A primitive the port does not run (HeightmapInline, Heightmap) is
    refused by name where a body uses it, and
    ignored where none does; a cylinder on a plane loads like the JAX
    package's."""
    for tag, prim in _UNPORTED_TAGS.items():
        doc = _CYLINDER_SCENE.replace(
            '<Cylinder id="c1" radius="0.5" height="1" density="1.0" />', prim)
        used = tmp_path / f"used_{tag}.xml"
        used.write_text(doc.format(inertia="", geom="c1"))
        with pytest.raises(NotImplementedError, match=tag):
            txml.load(str(used), device="cpu")
        # defined but referred to by no body (a visualization-only shape): loads
        unused = tmp_path / f"unused_{tag}.xml"
        unused.write_text(doc.format(inertia="", geom="p"))
        scene, _, _ = txml.load(str(unused), device="cpu")
        assert scene.nb == 2
    can = tmp_path / "can.xml"
    can.write_text(_CYLINDER_SCENE.format(
        inertia='<InertiaFromPrimitive primitive-id="c1" />', geom="c1"))
    jscene, jstate, _ = jxml.load(str(can))
    tscene, tstate, _ = txml.load(str(can), device="cpu")
    assert_same_compiled(tscene, tstate, jscene, jstate)
    assert [k for k, _ in tscene.kind_groups] == [tsc.K_CYLINDER_PLANE]


_OCTA_OBJ = """# an octahedron, outward faces
v 0.3 0 0
v -0.3 0 0
v 0 0.3 0
v 0 -0.3 0
v 0 0 0.3
v 0 0 -0.3
f 1 3 5
f 3 2 5
f 2 4 5
f 4 1 5
f 3 1 6
f 2 3 6
f 4 2 6
f 1 4 6
"""

_SHAPES_SCENE = """<XML>
<DRIVER step-size="0.001" />
<MOBY>
  <Cylinder id="cyl" radius="0.5" height="1" density="2.0" />
  <Cone id="cone" radius="0.6" height="1.2" mass="1.5" />
  <Torus id="tor" major-radius="1.0" minor-radius="0.25" density="0.5" />
  <Polyhedron id="oct" filename="octa.obj" mass="0.8" />
  <VertexCloud id="tet" vertices="0 0 0  0.4 0 0  0 0.4 0  0 0 0.4" mass="0.3" />
  <Plane id="p" />
  <GravityForce id="g" accel="0 0 -9.81" />
  <RigidBody id="can" position="0 0 0.5002" rpy="0 0 1.5707963267949" angular-velocity="2 0 0">
    <InertiaFromPrimitive primitive-id="cyl" />
    <CollisionGeometry primitive-id="cyl" />
  </RigidBody>
  <RigidBody id="cone" position="3 0 0.6002" rpy="1.5707963267949 0 0">
    <InertiaFromPrimitive primitive-id="cone" />
    <CollisionGeometry primitive-id="cone" />
  </RigidBody>
  <RigidBody id="torus" position="-3.5 0 0.2502">
    <InertiaFromPrimitive primitive-id="tor" />
    <CollisionGeometry primitive-id="tor" />
  </RigidBody>
  <RigidBody id="poly" position="0 4 0.3002">
    <InertiaFromPrimitive primitive-id="oct" />
    <CollisionGeometry primitive-id="oct" />
  </RigidBody>
  <RigidBody id="cloud" position="0.1 4 0.65">
    <InertiaFromPrimitive primitive-id="tet" />
    <CollisionGeometry primitive-id="tet" />
  </RigidBody>
  <RigidBody id="ground" enabled="false"><CollisionGeometry primitive-id="p" /></RigidBody>
  <TimeSteppingSimulator>
    <DynamicBody dynamic-body-id="can" /><DynamicBody dynamic-body-id="cone" />
    <DynamicBody dynamic-body-id="torus" /><DynamicBody dynamic-body-id="poly" />
    <DynamicBody dynamic-body-id="cloud" /><DynamicBody dynamic-body-id="ground" />
    <RecurrentForce recurrent-force-id="g" />
    <ContactParameters object1-id="ground" object2-id="can" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="poly" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="poly" object2-id="cloud" mu-coulomb="0.3" epsilon="0" />
{disabled}
  </TimeSteppingSimulator>
</MOBY></XML>"""


def write_shapes_scene(directory):
    """The primitive tags of this slice in one scene file, its Polyhedron
    an OBJ beside it: a cylinder, a cone and a torus on the plane, an
    octahedron on the plane and a tetrahedral vertex cloud on the
    octahedron; the pairs of the support-pair kinds disabled. Returns the
    scene's path."""
    curved = ("can", "cone", "torus")
    pairs = [(a, b) for i, a in enumerate(curved) for b in curved[i + 1:]]
    pairs += [(a, b) for a in curved for b in ("poly", "cloud")]
    disabled = "\n".join(f'    <DisabledPair object1-id="{a}" object2-id="{b}" />'
                          for a, b in pairs)
    (directory / "octa.obj").write_text(_OCTA_OBJ)
    path = directory / "shapes.xml"
    path.write_text(_SHAPES_SCENE.format(disabled=disabled))
    return path


def test_curved_and_convex_tags_load_like_jax(tmp_path):
    """<Cylinder>, <Cone>, <Torus>, <Polyhedron> (an OBJ read relative to
    the scene file) and <VertexCloud> load to the JAX loader's arrays, hull
    tables and masses; the pairs are kinds 3, 4, 5, 9 and 10."""
    path = write_shapes_scene(tmp_path)
    jscene, jstate, jopts = jxml.load(str(path))
    tscene, tstate, topts = txml.load(str(path), device="cpu")
    assert topts.step_size == jopts.step_size == 1e-3
    assert_same_compiled(tscene, tstate, jscene, jstate)
    assert {k for k, _ in tscene.kind_groups} == {3, 4, 5, 9, 10}
    # masses from the tags: density x volume, or the mass given
    np.testing.assert_allclose(
        t2n(tscene.mass)[:5],
        [2.0 * np.pi * 0.25, 1.5, 0.5 * 2 * np.pi ** 2 * 0.0625, 0.8, 0.3])
    cscene, cstate = torch_scene_state(jscene, jstate)
    assert_same_compiled(cscene, cstate, jscene, jstate)


def _obj(verts, faces):
    return "".join(f"v {float(x)!r} {float(y)!r} {float(z)!r}\n" for x, y, z in verts) + "".join(
        f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)


_MESH_SCENE = """<XML>
<DRIVER step-size="0.001" />
<MOBY>
  <TriangleMesh id="lm" filename="l.obj" density="2.0" />
  <TriangleMesh id="cm" filename="cube.obj" center="false" mass="0.5" />
  <TriangleMeshInline id="tet" vertices="0 0 0  0.4 0 0  0 0.4 0  0 0 0.4"
      faces="0 2 1  0 1 3  0 3 2  1 2 3" mass="1.2" />
  <Plane id="p" />
  <GravityForce id="g" accel="0 0 -9.81" />
  <RigidBody id="L" position="0 0 0.8335">
    <InertiaFromPrimitive primitive-id="lm" /><CollisionGeometry primitive-id="lm" />
  </RigidBody>
  <RigidBody id="cube" position="4 0 0.4002" angular-velocity="0 0 1">
    <InertiaFromPrimitive primitive-id="cm" /><CollisionGeometry primitive-id="cm" />
  </RigidBody>
  <RigidBody id="tet" position="8 0 0.0002">
    <InertiaFromPrimitive primitive-id="tet" /><CollisionGeometry primitive-id="tet" />
  </RigidBody>
  <RigidBody id="ground" enabled="false"><CollisionGeometry primitive-id="p" /></RigidBody>
  <TimeSteppingSimulator>
    <DynamicBody dynamic-body-id="L" /><DynamicBody dynamic-body-id="cube" />
    <DynamicBody dynamic-body-id="tet" /><DynamicBody dynamic-body-id="ground" />
    <RecurrentForce recurrent-force-id="g" />
    <ContactParameters object1-id="ground" object2-id="L" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="cube" mu-coulomb="0.5" epsilon="0" />
    <ContactParameters object1-id="ground" object2-id="tet" mu-coulomb="0.5" epsilon="0" />
    <DisabledPair object1-id="L" object2-id="cube" />
    <DisabledPair object1-id="L" object2-id="tet" />
    <DisabledPair object1-id="cube" object2-id="tet" />
  </TimeSteppingSimulator>
</MOBY></XML>"""


def write_mesh_scene(directory):
    """A scene of the mesh tags, its OBJs beside it: the L-prism as a
    <TriangleMesh> centred on its COM (mass from `density`), a cube 0.1 m
    off its origin as a <TriangleMesh> with center="false" and a mass below
    1 kg, and a tetrahedron as a <TriangleMeshInline>, each on the plane
    (kind 3). Returns the scene's path."""
    from moby_tpu_torch.geometry import trimesh as ttm

    lv, lf = ttm.extrude_polygon([(0, 0), (2, 0), (2, 1), (1, 1), (1, 2), (0, 2)],
                                 -0.5, 0.5)
    (directory / "l.obj").write_text(_obj(lv + [0.3, 0.0, 0.0], lf))
    cv = np.array([[sx, sy, sz] for sz in (-0.4, 0.4) for sy in (-0.4, 0.4)
                   for sx in (-0.4, 0.4)])
    cf = np.array([[0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
                   [2, 6, 7], [2, 7, 3], [1, 3, 7], [1, 7, 5], [0, 4, 6], [0, 6, 2]])
    (directory / "cube.obj").write_text(_obj(cv + [0.1, 0.0, 0.0], cf))
    path = directory / "meshes.xml"
    path.write_text(_MESH_SCENE)
    return path


def test_mesh_tags_load_like_jax(tmp_path):
    """<TriangleMesh> (an OBJ read relative to the scene file, center true
    and false, density without mass) and <TriangleMeshInline> load to the JAX
    loader's arrays, face tables and masses; the pairs are kind 3."""
    path = write_mesh_scene(tmp_path)
    jscene, jstate, _ = jxml.load(str(path))
    tscene, tstate, _ = txml.load(str(path), device="cpu")
    assert_same_compiled(tscene, tstate, jscene, jstate)
    assert [k for k, _ in tscene.kind_groups] == [tsc.K_PLANE_GENERIC]
    for k in ("geom_faces", "geom_nfaces", "geom_verts", "geom_nverts"):
        np.testing.assert_array_equal(tscene.host[k], np.asarray(getattr(jscene, k)), err_msg=k)
    np.testing.assert_allclose(t2n(tscene.mass)[:3], [2.0 * 3.0, 0.5, 1.2])
    verts, nv = tscene.host["geom_verts"], tscene.host["geom_nverts"]
    # centred: the L's COM at its origin; not centred: the cube's 0.1 m offset kept
    from moby_tpu_torch.geometry import trimesh as ttm

    com = ttm.mesh_mass_properties(verts[0, :nv[0]], tscene.host["geom_faces"][0, :24])[1]
    np.testing.assert_allclose(com, 0.0, atol=1e-12)
    np.testing.assert_allclose(verts[1, :8].mean(axis=0), [0.1, 0.0, 0.0], atol=1e-12)
    cscene, cstate = torch_scene_state(jscene, jstate)
    assert_same_compiled(cscene, cstate, jscene, jstate)


def test_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="cuda"):
        txml.load(str(REPO / TABLE_XML))


def test_table_import_pulls_in_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "from moby_tpu_torch.io import mobyxml\n"
        "from moby_tpu_torch.sim import stepper\n"
        "from moby_tpu_torch.solvers import hopper_lcp\n"
        f"scene, st, opts = mobyxml.load({TABLE_XML!r}, device='cpu')\n"
        "st = stepper.step(scene, st.expand(2), 1e-3, device='cpu')\n"
        "assert st.q_art.shape == (2, 7)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'moby_tpu', 'triton')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert hopper_lcp._libs is None\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
