"""Churn under the port's staleness-1 pipelined step (one mask held over
the step's M rounds, a rejoiner's carried-over stale bucket gated off in
round 0, each round's own corruption draw), against the JAX package's
trainer with the harness of test_torch_churn_trainer.py (losses rtol 1e-4,
wire by tag equal, churn tallies exact):

* M 2 on the int8 wire with EF under 30% dropout (window steps 1-3),
  chip_smoke.py's (al);
* M 2 at corruption rate 0 with a kind set (the integrity program) against
  the plain pipelined cell: equal losses in both packages, bitwise in the
  port, and no quarantined round.
"""

import numpy as np
import pytest

from test_torch_churn_trainer import (  # noqa: F401
    DROP,
    Q_EF,
    REFERENCE,
    _one_thread,
    assert_matches,
    run_cell,
)
from test_torch_sync import reference_in_subprocess

PIPE = dict(**Q_EF, overlap="pipelined", overlap_staleness=1)
CELLS = {
    "al": (dict(**PIPE, **DROP), 2, 1),
    "pipe_corr0": (dict(**PIPE, churn=True, corruption_kind="bitflip"), 2, 1),
    "pipe_plain": (dict(**PIPE), 2, 1),
}


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("name", list(CELLS))
def test_pipelined_churn_cell_matches_reference(name, reference):
    assert_matches(name, reference[name], run_cell(name, CELLS))


def test_pipelined_corruption0_is_the_plain_cell(reference):
    _, _, state, corr0 = run_cell("pipe_corr0", CELLS)
    plain = run_cell("pipe_plain", CELLS)[3]
    np.testing.assert_array_equal(corr0, plain)
    np.testing.assert_array_equal(reference["pipe_corr0"]["loss"], reference["pipe_plain"]["loss"])
    assert float(state["comm"]["quarantine_total"].sum()) == 0.0
