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
launching a port kernel.  Losses, parameters (each rank its own rows of
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
CELLS = {
    "qsgd_kernel_ef": (dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, **CW),
                       ("qsgd_ef", "int8_acc")),
    "signsgd_packed_ef": (dict(compressor="signsgd_packed", **CW), ("sign_pack", "sign_vote")),
    "dpsgd": (dict(aggregator="gossip", bucket_mb=0.5), ()),
    "ring": (dict(collective="ring", bucket_mb=0.5), ()),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ranks_on_the_card_are_the_stacked_run(cuda, tmp_path):
    cells = [{"name": n, "workers": W, "steps": 3, "lr": 0.01, "comm": kw}
             for n, (kw, _) in CELLS.items()]
    got = twins(cells, R, str(tmp_path), timeout=900, device="cuda", deterministic=True,
                env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    for c in cells:
        stacked, ranked = got[c["name"]]
        assert differences(stacked, ranked) == [], c["name"]
        nb = len(make_cell(c, None, "cpu")[0].bucket_plan.buckets)
        kernels = CELLS[c["name"]][1]
        send, recv = kernels or (None, None)
        assert json.loads(str(stacked["launches"])) == (
            {send: 3 * W * nb, recv: 3 * nb} if kernels else {})
        for rec in ranked:
            assert json.loads(str(rec["launches"])) == (
                {send: 3 * W // R * nb, recv: 3 * nb} if kernels else {})
            stats = json.loads(str(rec["stats"]))
            assert stats["staged"] > 0 and stats["sent"] == stats["received"] > 0
