"""The port's roofline substrate (``repro_torch.launch.roofline``, the
runner's ``roofline_row`` and ``predict(s, "roofline")``) against the
reference's, and ``run.py``'s roofline and trainer lanes through
``main(argv)`` on the CPU.

* With the port's constants monkeypatched to the reference's (TPU v5e:
  197 TFLOP/s, 819 GB/s, 2 x 50 GB/s links), every roofline term equals the
  reference's at rtol 1e-12 and the bottleneck agrees, over cells whose
  HBM passes cover dense (3), ``qsgd`` (2.5 more), ``qsgd`` with error
  feedback (8 more) and ``qsgd_kernel`` with error feedback (the fused
  kernel: 4.25 more), and every sync x architecture of the default grid;
  the port's own constants are the H100 SXM data sheet's.
* ``--substrate roofline`` through ``main(argv)``: the emitted cells equal
  the reference's under the patched constants; finite terms with the
  H100's.
* ``--substrate trainer --device cpu`` through ``main(argv)``: the cells
  run, grouped by class (the ``bundle`` block), a cell that cannot run is
  dropped with the reference's reason.
"""

import json
import math

import numpy as np
import pytest

from repro.experiments import Scenario as JScenario
from repro.experiments import run as jrun
from repro.experiments import runner as jrunner
from repro.launch import roofline as JRL
from repro_torch.experiments import Scenario
from repro_torch.experiments import run as prun
from repro_torch.experiments import runner as prunner
from repro_torch.launch import roofline as RL
from test_torch_sync import _one_thread  # noqa: F401

#: name -> (Scenario fields, the HBM passes they must charge)
CELLS = {
    "dense": (dict(), 3.0),
    "qsgd": (dict(compressor="qsgd", compressor_kwargs={"levels": 16}), 5.5),
    "qsgd_ef": (dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                     error_feedback=True), 11.0),
    "qsgd_kernel_ef": (dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                            error_feedback=True), 7.25),
    "terngrad_kernel_ef": (dict(compressor="terngrad_kernel", error_feedback=True), 11.0),
    "local_topk": (dict(sync="local", local_steps=4, compressor="topk",
                        compressor_kwargs={"ratio": 0.01}), 5.5),
    "gossip_sign": (dict(arch="gossip", compressor="signsgd"), 5.5),
    "ps_asp": (dict(arch="ps", sync="asp", compressor="terngrad"), 5.5),
}


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline constants set to the reference's TPU v5e ones."""
    monkeypatch.setattr(RL, "PEAK_FLOPS", JRL.PEAK_FLOPS)
    monkeypatch.setattr(RL, "HBM_BW", JRL.HBM_BW)
    monkeypatch.setattr(RL, "LINK_BW", JRL.ICI_BW)
    monkeypatch.setattr(RL, "LINKS", JRL.ICI_LINKS)


def test_constants_are_the_h100_data_sheet():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW * RL.LINKS) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("workers,compute", [(4, 1.0), (16, 0.05)])
def test_roofline_terms_match_reference(reference_constants, name, workers, compute):
    kw, passes = CELLS[name]
    s = Scenario(n_workers=workers, compute_time=compute, **kw)
    js = JScenario(n_workers=workers, compute_time=compute, **kw)
    assert prunner._hbm_passes(s) == jrunner._hbm_passes(js) == passes
    got, want = prunner.roofline_row(s), jrunner.roofline_row(js)
    assert got.keys() == want.keys() and got["bottleneck"] == want["bottleneck"]
    for k in ("t_compute", "t_memory", "t_collective", "iter_time_bound"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    got, want = prunner.predict(s, "roofline"), jrunner.predict(js, "roofline")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    r = prunner.run_scenario(s, "roofline")
    assert r.substrate == "roofline" and r.measured == prunner.roofline_row(s)


def test_roofline_term_algebra():
    r = RL.Roofline(arch="allreduce", shape="x", mesh="n4", flops=989e12 * 2,
                    hbm_bytes=3.35e12, coll_bytes=450e9 * 3, coll_bytes_hlo=0.0,
                    coll_by_kind={}, backward_factor=2.0)
    assert (r.t_compute, r.t_memory, r.t_collective) == (2.0, 1.0, 6.0)
    assert r.bottleneck == "collective" and r.row()["t_collective"] == 6.0


def _emitted(main, argv, tmp_path, name):
    path = tmp_path / f"{name}.json"
    assert main(argv + ["--emit-json", str(path)]) == 0
    return json.loads(path.read_text())


def test_main_roofline_matches_reference(reference_constants, tmp_path):
    argv = ["--substrate", "roofline"]
    want = _emitted(jrun.main, argv, tmp_path, "ref")
    got = _emitted(prun.main, argv, tmp_path, "port")
    assert got["n_cells"] == want["n_cells"] > 0
    for g, w in zip(got["cells"], want["cells"]):
        assert g["tag"] == w["tag"] and g["measured"]["bottleneck"] == w["measured"]["bottleneck"]
        for part in ("measured", "predicted"):
            for k, v in w[part].items():
                if k != "bottleneck":
                    np.testing.assert_allclose(g[part][k], v, rtol=1e-12, atol=0)


def test_main_roofline_h100_terms_are_finite(tmp_path):
    rec = _emitted(prun.main, ["--substrate", "roofline"], tmp_path, "h100")
    for c in rec["cells"]:
        assert all(math.isfinite(v) for k, v in c["measured"].items() if k != "bottleneck")


def test_main_trainer_on_cpu(tmp_path, capsys):
    from repro_torch.train.steps import bundle_cache_clear

    bundle_cache_clear()  # the registry is the process's: start from an empty one
    argv = ["--substrate", "trainer", "--device", "cpu", "--workers", "4", "--steps", "2",
            "--grid", "sync=bsp,local,asp compressor=qsgd:levels=4,qsgd:levels=16"]
    rec = _emitted(prun.main, argv, tmp_path, "trainer")
    err = capsys.readouterr().err
    assert "dropped invalid cell asp" in err and "bundle cache: 4 cells" in err
    assert rec["substrate"] == "trainer" and rec["n_cells"] == 4
    assert rec["bundle"] == {**rec["bundle"], "n_shape_classes": 2, "builds": 2,
                             "cache_hits": 2, "device": "cpu"}
    for c in rec["cells"]:
        assert math.isfinite(c["measured"]["final_loss"]) and c["measured"]["wire_kb_per_step"] > 0
        assert c["predicted"]["calibrated"] == 0.0
