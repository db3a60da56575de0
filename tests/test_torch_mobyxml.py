"""PyTorch port: the Moby XML loader `moby_tpu_torch.io.mobyxml` against
`moby_tpu.io.mobyxml`, and the articulated scenes built by both packages'
`SceneBuilder`s, float64 on the CPU.

Both in-repo scenes and the articulated test scenes compile to the same
arrays (equal, not close); a compiled JAX scene carried across with
`scene_from_arrays` equals the port's own compile; what the port does not
run raises `NotImplementedError` naming it; loading and stepping a scene
imports neither JAX nor Triton.
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
    build_pendulum_ball, torch_scene_state,
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


def test_unported_primitive_raises_naming_it(tmp_path):
    used = tmp_path / "used.xml"
    used.write_text(_CYLINDER_SCENE.format(
        inertia='<InertiaFromPrimitive primitive-id="c1" />', geom="c1"))
    with pytest.raises(NotImplementedError, match="Cylinder"):
        txml.load(str(used), device="cpu")
    # defined but referred to by no body (a visualization-only shape): loads
    unused = tmp_path / "unused.xml"
    unused.write_text(_CYLINDER_SCENE.format(inertia="", geom="p"))
    scene, _, _ = txml.load(str(unused), device="cpu")
    assert scene.nb == 2


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
