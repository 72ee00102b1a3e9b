"""The trainer's integrity program against the JAX package's trainer with
test_torch_churn_trainer.py's harness (losses rtol 1e-4, wire by tag equal,
the quarantine and escalation tallies exact): each corruption kind at 60%
with ``quarantine_limit`` 2 on BSP ``qsgd`` 16 with EF on the dense wire
(the gather-and-decompress route: every payload leaf corrupted in its
domain, each gathered row validated), as the reference's
``test_trainer_corruption_kinds_detected``: every cell quarantines rounds
and escalates.  (test_torch_churn_pod.py holds the dense all-reduce's and
the int8 majority's integrity cells.)
"""

import pytest

from test_torch_churn_trainer import REFERENCE, _one_thread, assert_matches, run_cell  # noqa: F401
from test_torch_sync import reference_in_subprocess

QSGD = dict(compressor="qsgd", compressor_kwargs={"levels": 16}, error_feedback=True)
HOT = dict(corruption_rate=0.6, quarantine_limit=2)
CELLS = {kind: (dict(**QSGD, **HOT, corruption_kind=kind), 1, 1)
         for kind in ("nan", "inf", "spike", "bitflip")}


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("name", list(CELLS))
def test_corruption_cell_matches_reference_trainer(name, reference):
    _, _, state, _ = got = run_cell(name, CELLS)
    assert_matches(name, reference[name], got)
    assert float(state["comm"]["quarantine_total"].sum()) > 0
    assert float(state["comm"]["escalation_total"].sum()) > 0
