"""PowerSGD, the pipelined step and ZeRO-1 over diverging rows on the
model axis against the reference's ``Trainer`` on a (data, model) = (4,
2) mesh, with the harness of test_torch_model_axis_churn.py (the tiny
workload, 4 steps, the reference's parameters, its key chain replayed).
Cells:

* PowerSGD rank 2 with error feedback: a Q per (worker, shard), every
  shard's bucket i from the reference's ``key(1000 + i)`` draw at the
  shard-local size (handed over in the reference's global layout), the two
  factor psums over ``data``; each device's final Q equal to the
  reference's up to each column's sign (rtol 1e-4 / atol 1e-4 of the
  largest entry: another matmul order and QR, and 4 steps of training
  parting the sums: 4.3e-5 of the largest entry here);
* the pipelined step (microbatch 2) at staleness 1 on the int8 wire with
  EF under 30% dropout (one mask held over the rounds, ``overlap_pending``
  per (worker, shard)), and at staleness 0;
* pod-local SGD at 2 pods x 2 x model 2, H 2, ZeRO-1 over the pods'
  diverging rows under 25% dropout: every row equal after every step.

Losses within rtol 1e-4, wire by (tag, axes) and the per-(worker, shard)
churn entries as there.  One 8-device subprocess runs the reference.
(test_torch_model_axis.py holds the new state's checkpoint round trip and
the entry points.)"""

import numpy as np
import pytest

from test_torch_model_axis_churn import D, M, Q_EF, assert_cell_matches, port_cell, run_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

PSGD = dict(compressor="powersgd", compressor_kwargs={"rank": 2}, error_feedback=True)
PIPE = dict(**Q_EF, overlap="pipelined")
#: name -> (CommConfig fields, lr, microbatch, pods, optimizer); 4 steps
CELLS = {
    "powersgd": (PSGD, 0.05, 1, 1, ""),
    "pipe_s1": (dict(**PIPE, overlap_staleness=1, dropout_rate=0.3), 0.05, 2, 1, ""),
    "pipe_s0": (dict(**PIPE, overlap_staleness=0), 0.05, 2, 1, ""),
    "pod_zero1": (dict(pod_local=True, local_steps=2, **Q_EF, dropout_rate=0.25), 0.05, 1, 2,
                  "zero1"),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_axis_options") / "params.npz"
    return run_reference(CELLS, path), dict(np.load(path))


@pytest.mark.parametrize("name", list(CELLS))
def test_option_on_model_axis_matches_reference(name, reference):
    ref, flat = reference
    got = port_cell(CELLS, name, flat, ref[name])
    assert_cell_matches(CELLS, name, ref[name], got)
    b, _, state, rows_equal = got
    if name == "pod_zero1":  # the pods' rows made equal by every ZeRO-1 step
        assert rows_equal == [True] * 4
        v = state["opt"]["inner"]["v"]
        assert all(x.shape[:2] == (D, M) for x in v)
    if name == "pipe_s1":
        assert all(p.shape[0] == D * M for p in state["comm"]["overlap_pending"])
    if name == "powersgd":
        qs = b.checkpoint_tree(state)["comm"]["psgd_q"]
        assert [q.numel() for q in qs] == [len(q) for q in ref[name]["psgd_q"]]
        for q, want in zip(qs, ref[name]["psgd_q"]):
            if not len(want):
                continue
            rank = CELLS[name][0]["compressor_kwargs"]["rank"]
            got_q = q.numpy().reshape(D * M, -1, rank)  # each device's (b, rank)
            want_q = np.asarray(want).reshape(D * M, -1, rank)
            sign = np.sign(np.sum(got_q * want_q, axis=1, keepdims=True))
            np.testing.assert_allclose(got_q * sign, want_q, rtol=1e-4,
                                       atol=1e-4 * np.abs(want_q).max())

