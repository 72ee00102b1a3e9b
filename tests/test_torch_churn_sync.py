"""Churn, rejoin and integrity on the port's parameter-averaging sync
(``StepBundle.sync_step`` over ``sync.average_params`` with ``alive``,
``donor`` and ``payload``), against the JAX package's trainer with the
harness of test_torch_churn_trainer.py (losses rtol 1e-4, wire by tag
equal, churn tallies exact):

* local SGD H 2 on the int8 wire with EF under 30% dropout (window steps
  1-3), ``pull_avg`` (chip_smoke.py's (aj)) and ``reset`` on the dense
  wire: the masked average over both rejoin policies;
* local SGD under 60% NaN corruption of the parameters' wire copy,
  ``quarantine_limit`` 2, and post-local SGD (switch 2, H 2) under dropout
  and 50% bitflip corruption: the sync wire's quarantine and escalation;
* ``average_params`` with ``alive`` and ``donor``: the donor count's
  booked psum, dead rows frozen, live rows on the donors' mean.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import comms, sync
from test_torch_churn_trainer import (  # noqa: F401
    DROP,
    Q_EF,
    REFERENCE,
    _one_thread,
    assert_matches,
    run_cell,
)
from test_torch_sync import reference_in_subprocess

QSGD = dict(compressor="qsgd", compressor_kwargs={"levels": 16}, error_feedback=True)
CELLS = {
    "aj": (dict(sync="local", local_steps=2, **Q_EF, **DROP, rejoin_policy="pull_avg"), 1, 1),
    "local_reset": (dict(sync="local", local_steps=2, **QSGD, **DROP), 1, 1),
    "local_nan": (dict(sync="local", local_steps=2, **QSGD, corruption_rate=0.6,
                       corruption_kind="nan", quarantine_limit=2), 1, 1),
    "post_local": (dict(sync="post_local", post_local_switch=2, local_steps=2, **Q_EF,
                        dropout_rate=0.3, corruption_rate=0.5, corruption_kind="bitflip"), 1, 1),
}


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("name", list(CELLS))
def test_sync_churn_cell_matches_reference_trainer(name, reference):
    assert_matches(name, reference[name], run_cell(name, CELLS))


def test_masked_average_books_the_donor_count():
    """average_params with alive: a scalar psum of the donor bits, then the
    leaves, all under local_sgd_sync; a dead row keeps its parameters, the
    live rows take the donors' mean; donor or payload without alive raises."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 10)).astype(np.float32))
    p = x.clone()
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0])
    donor = torch.tensor([1.0, 0.0, 0.0, 1.0])
    with comms.capture() as log:
        sync.average_params([p], alive=alive, donor=donor)
    assert [(r.kind, r.payload_bytes, r.tag) for r in log.records] == [
        ("psum", 4, "local_sgd_sync"), ("psum", 40, "local_sgd_sync")]
    want = (x[0] + x[3]) / 2
    torch.testing.assert_close(p[[0, 2, 3]], want.expand(3, 10), rtol=1e-6, atol=0)
    assert torch.equal(p[1], x[1])
    with pytest.raises(ValueError, match="alive"):
        sync.average_params([p], donor=donor)
