"""Churn on the port's pod-local SGD and the 1-bit wire, and PowerSGD
under pod-local SGD over several pods, against the JAX package's trainer
with the harness of test_torch_churn_trainer.py (losses rtol 1e-4, wire by
tag equal, churn tallies exact):

* pod-local SGD at P 2 x D 2 under 30% dropout (window steps 1-3), H 2,
  ``qsgd_kernel`` EF on the int8 wire (chip_smoke.py's (am)): per-worker
  masks inside each pod, the pod's sync bit from its workers' last bits
  (a booked psum over ``data``); by tag and by (tag, axes);
* PowerSGD rank 2 with EF under pod-local SGD at P 2 x D 2: one Q per pod,
  as the reference keeps it;
* ``signsgd_packed`` on the 1-bit wire with EF under dropout ((ak));
* integrity on the psum routes: the dense all-reduce (no compressor) under
  50% NaN corruption and 30% dropout, its live-and-valid count a booked
  scalar psum, and ``signsgd``'s int8 majority on the dense wire with
  momentum correction under 50% bitflip (the codes' range check; a
  quarantined round's momentum undone).
"""

import numpy as np
import pytest
import torch

from test_torch_churn_trainer import (  # noqa: F401
    DROP,
    Q_EF,
    REFERENCE,
    _one_thread,
    assert_matches,
    by_tag_axes,
    run_cell,
)
from test_torch_sync import reference_in_subprocess

CELLS = {
    "am": (dict(pod_local=True, local_steps=2, bucket_mb=4.0, **Q_EF, **DROP), 1, 2),
    "pod_psgd": (dict(pod_local=True, local_steps=2, bucket_mb=4.0, compressor="powersgd",
                      compressor_kwargs={"rank": 2}, error_feedback=True), 1, 2),
    "ak": (dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True,
                **DROP), 1, 1),
    "dense": (dict(corruption_rate=0.5, corruption_kind="nan", dropout_rate=0.3), 1, 1),
    "majority": (dict(compressor="signsgd", error_feedback=True, momentum_correction=0.9,
                      corruption_rate=0.5, corruption_kind="bitflip"), 1, 1),
}


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("name", list(CELLS))
def test_pod_sign_and_psum_churn_cell_matches_reference(name, reference):
    got = run_cell(name, CELLS)
    assert_matches(name, reference[name], got)
    if CELLS[name][2] > 1:  # the pod cells: the (tag, axes) pairs too
        logs = got[0].logs
        assert (set(by_tag_axes(logs["train"])) | set(by_tag_axes(logs["sync"]))
                == set().union(*reference[name]["logs"]))


def test_pod_powersgd_keeps_one_q_per_pod():
    """After a step the pods' Q differ (each psums over its own workers)."""
    _, _, state, losses = run_cell("pod_psgd", CELLS, steps=1)
    assert np.isfinite(losses).all()
    q = [x for x in state["comm"]["psgd_q"] if x.numel()]
    assert q and all(x.shape[0] == 2 for x in q)
    assert any(not torch.equal(x[0], x[1]) for x in q)
