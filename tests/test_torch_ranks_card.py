"""Ranks on the card (gpu-marked; imports no jax and nothing of the
reference): the tiny workload at W = 4 over R = 2 gloo processes on one
card (its tensors staged through pinned host buffers), 3 steps, against
the same cells stacked in one process on the card (the tests' harness
``torch_ranked``), both under
``torch.use_deterministic_algorithms(True)`` and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (the card's embedding backward
accumulates by atomics otherwise): ``qsgd_kernel`` EF (kernels qsgd_ef and
int8_acc) and ``signsgd_packed`` EF (sign_pack and sign_vote) on the
compressed wire; D-PSGD (its boundary rows sent to the neighbour ranks) and
BSP on the ``ring`` schedule (its hops sent between the ranks), neither
launching a port kernel; the pipelined step at staleness 1 over
``qsgd_kernel`` EF with 2 microbatches (its rounds on the side stream from
the communication thread, which the main thread's recorded waits,
``exposed_s``, show) and BSP ``churn_qsgd`` (25% dropout, 25% NaN,
``quarantine_limit`` 2; each rank drawing and validating its own
workers).  Losses, parameters (each rank its own rows of
D-PSGD's), EF and momentum rows bitwise, every rank's parameters bitwise
rank 0's where both hold them, the records equal by tag and axes; each
rank launches its own workers' send-side kernels and every bucket's
reduction, and stages bytes through the host."""

import json

import pytest
import torch

from torch_ranked import differences, make_cell, twins

W, R = 4, 2
CW = dict(wire_format="compressed", error_feedback=True, bucket_mb=0.5)
Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, **CW)
#: name -> (CommConfig fields, the send- and receive-side kernels, rounds a step)
CELLS = {
    "qsgd_kernel_ef": (Q_EF, ("qsgd_ef", "int8_acc"), 1),
    "signsgd_packed_ef": (dict(compressor="signsgd_packed", **CW), ("sign_pack", "sign_vote"), 1),
    "dpsgd": (dict(aggregator="gossip", bucket_mb=0.5), (), 1),
    "ring": (dict(collective="ring", bucket_mb=0.5), (), 1),
    "pipelined_s1": (dict(Q_EF, overlap="pipelined", overlap_staleness=1),
                     ("qsgd_ef", "int8_acc"), 2),
    "churn_qsgd": (dict(Q_EF, dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25,
                        quarantine_limit=2), ("qsgd_ef", "int8_acc"), 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ranks_on_the_card_are_the_stacked_run(cuda, tmp_path):
    cells = [{"name": n, "workers": W, "steps": 3, "lr": 0.01, "comm": kw,
              "microbatch": 2 if n.startswith("pipelined") else 1}
             for n, (kw, _, _) in CELLS.items()]
    got = twins(cells, R, str(tmp_path), timeout=900, device="cuda", deterministic=True,
                env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    for c in cells:
        stacked, ranked = got[c["name"]]
        assert differences(stacked, ranked) == [], c["name"]
        nb = len(make_cell(c, None, "cpu")[0].bucket_plan.buckets)
        _, kernels, rounds = CELLS[c["name"]]
        send, recv = kernels or (None, None)
        n = 3 * rounds * nb  # steps x rounds x buckets
        assert json.loads(str(stacked["launches"])) == ({send: n * W, recv: n} if kernels else {})
        for rec in ranked:
            assert json.loads(str(rec["launches"])) == (
                {send: n * W // R, recv: n} if kernels else {})
            stats = json.loads(str(rec["stats"]))
            assert stats["staged"] > 0 and stats["sent"] == stats["received"] > 0
            assert (stats["exposed_s"] > 0) == c["name"].startswith("pipelined"), stats
        if c["name"] == "churn_qsgd":  # not vacuous: payloads were quarantined
            assert sum(float(v) for k, v in stacked.items()
                       if k.startswith("quarantine_total/")) > 0
