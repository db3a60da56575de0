"""PyTorch port: the regress and compare CLIs (`moby_tpu_torch.cli`)
against the JAX package's (`moby_tpu.cli`), float64 on the CPU.

Both packages dump the two in-repo scenes over 20 steps; the dumps agree
within 1e-5 by the port's `compare` (lines are printed with `%g`, 6
significant digits, so equal states may differ by a unit in the last one)
and the states themselves within 1e-10.
"""

import jax
import numpy as np
import pytest
import torch

from moby_tpu.cli import compare as jcmp
from moby_tpu.cli import regress as jreg
from moby_tpu.io import mobyxml as jxml
from moby_tpu_torch.cli import compare as tcmp
from moby_tpu_torch.cli import regress as treg
from moby_tpu_torch.io import mobyxml as txml
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_helpers import SITTING_BOX_XML, TABLE_XML, t2n

STEPS = 20


@pytest.mark.parametrize("xml", [SITTING_BOX_XML, TABLE_XML],
                         ids=["sitting_box", "table"])
def test_regress_dump_matches_jax(xml, tmp_path, monkeypatch):
    jout, tout = tmp_path / "jax.dat", tmp_path / "torch.dat"
    # keep the JAX CLI's compiled step to roll its states out below
    real_jit, kept = jax.jit, []

    def keeping_jit(f, *a, **kw):
        kept.append(real_jit(f, *a, **kw))
        return kept[-1]

    monkeypatch.setattr(jax, "jit", keeping_jit)
    assert jreg.main([f"-mi={STEPS}", "--cpu", xml, str(jout)]) == 0
    monkeypatch.setattr(jax, "jit", real_jit)
    assert treg.main([f"-mi={STEPS}", "--cpu", xml, str(tout)]) == 0

    err, where, n = tcmp.compare(str(jout), str(tout))
    assert n == STEPS and err <= 1e-5, (err, where)
    assert tcmp.main([str(jout), str(tout), "1e-5"]) == 0
    # the port's copy of compare agrees with the JAX package's
    assert jcmp.compare(str(jout), str(tout)) == (err, where, n)
    rows = tcmp.load_traj(str(tout))
    assert len(rows) == STEPS and len(set(map(len, rows))) == 1

    # the states, unrounded: the port's `dump` against the JAX CLI's step
    jscene, jst, opts = jxml.load(xml)
    for _ in range(STEPS):        # the last step's line is not written
        jst = kept[0](jst)
    scene, st, _ = txml.load(xml, device="cpu")
    with open(tmp_path / "again.dat", "w") as f:
        st = treg.dump(scene, st, opts.step_size, f, max_iter=STEPS, device="cpu")
    assert st.pos.dtype == torch.float64
    for name in ("pos", "quat", "vel", "omega", "q_art", "qd_art", "time"):
        np.testing.assert_allclose(t2n(getattr(st, name))[0],
                                   np.asarray(getattr(jst, name)), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_compare_reports_and_fails_above_tolerance(tmp_path, capsys):
    a, b = tmp_path / "a.dat", tmp_path / "b.dat"
    a.write_text("0 1 2\n0.1 1 2.5\n0.25\n")
    b.write_text("0 1 2\n0.1 1.25 2.5\n0.5\n")
    assert tcmp.load_traj(str(a)) == [[0.0, 1.0, 2.0], [0.1, 1.0, 2.5]]
    assert tcmp.compare(str(a), str(b)) == (0.25, (1, 1), 2)
    assert tcmp.main([str(a), str(b), "0.3"]) == 0
    assert tcmp.main([str(a), str(b), "0.2"]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert tcmp.main([str(a)]) == 2


def test_regress_defaults_to_the_card_and_refuses_plugins(tmp_path):
    out = str(tmp_path / "x.dat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            treg.main(["-mi=1", SITTING_BOX_XML, out])
    with pytest.raises(NotImplementedError, match="rimless_wheel"):
        treg.main(["-p=rimless_wheel", "--cpu", SITTING_BOX_XML, out])
    assert treg.main([]) == 1
