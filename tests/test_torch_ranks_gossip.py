"""Gossip over ranks of the data axis: D-PSGD and CHOCO-SGD on the tiny
workload at W = 4 over R = 2 and R = 4 gloo processes on the CPU (the
tests' harness ``torch_ranked``; torch on one thread in every rank), 3
steps at lr 0.05 under ``momentum_sgd(0.9)``, bucket_mb 0.5 (several
buckets), against the same cells stacked in this process.

* D-PSGD, CHOCO-SGD with ``qsgd_kernel`` (16 levels) and with
  ``signsgd_packed``, and a compressor-less CHOCO-SGD, which mixes by plain
  D-PSGD as in the reference.  Bitwise: losses, every parameter, momentum
  and CHOCO mirror row (each held by some rank, each rank only its own
  W/R rows), the records captured over the run and the booked gossip
  program.
* The bytes a rank sends a step, to the byte: its three metrics to the
  other ranks, and per bucket of n elements the ring's two boundary hops
  that cross to the neighbour ranks: D-PSGD's f32 rows, 2 x 4n; CHOCO-SGD's
  compressed payloads of its first and last worker, 2 x the payload's
  bytes (the codes and norm, the packed signs and scale), never the
  decoded rows.  As many received."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.compression.base import get_compressor, needs_noise, noise_len
from test_torch_ranks import W, cell, check_against_stacked, run_ranked, run_stacked
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import make_cell

GOSSIP = dict(aggregator="gossip", bucket_mb=0.5)
CHOCO = dict(GOSSIP, gossip_compress="choco")
CELLS = {
    "dpsgd": GOSSIP,
    "choco_qsgd_kernel": dict(CHOCO, compressor="qsgd_kernel", compressor_kwargs={"levels": 16}),
    "choco_signsgd_packed": dict(CHOCO, compressor="signsgd_packed"),
    "choco_none": CHOCO,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("ranks_gossip")
    cells = [cell(n, comm=kw) for n, kw in CELLS.items()]
    (root / "r2").mkdir(), (root / "r4").mkdir()
    with ThreadPoolExecutor(2) as pool:
        launches = {w: pool.submit(run_ranked, cells, w, root / f"r{w}") for w in (2, 4)}
        stacked = {c["name"]: run_stacked(c) for c in cells}
        return stacked, {w: f.result() for w, f in launches.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CELLS))
def test_gossip_over_ranks_matches_stacked(name, world, runs):
    stacked, ranked = runs
    assert np.isfinite(stacked[name]["loss"]).all()
    check_against_stacked(stacked[name], ranked[world][name], rows=W)
    if name.startswith("choco") and name != "choco_none":  # the mirrors, by worker
        assert any(k.startswith("choco_xhat/") for k in ranked[world][name][0])


def _hop_bytes(name: str) -> int:
    """One worker's bytes of one ring hop, summed over the buckets."""
    bundle = make_cell(cell(name, comm=CELLS[name]), None, "cpu")[0]
    comm = bundle.comm
    comp = get_compressor(comm.compressor, **comm.compressor_kwargs)
    total = 0
    for b in bundle.bucket_plan.buckets:
        if comp is None or comm.gossip_compress != "choco":
            total += 4 * b.size  # the f32 row
            continue
        u = torch.rand(noise_len(comp, b.size)) if needs_noise(comp) else None
        total += comp.compress(u, torch.randn(b.size)).payload_bytes()
    return total


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CELLS))
def test_gossip_step_moves_the_boundary_hops(name, world, runs):
    _, ranked = runs
    metrics = 3 * 4 * (W // world) * (world - 1)
    want = metrics + 2 * _hop_bytes(name)
    if name == "choco_qsgd_kernel":  # int8 codes and an f32 norm a bucket
        bundle = make_cell(cell(name, comm=CELLS[name]), None, "cpu")[0]
        assert want == metrics + 2 * sum(b.size + 4 for b in bundle.bucket_plan.buckets)
    for rec in ranked[world][name]:
        steps = json.loads(str(rec["step_stats"]))
        assert [s["sent"] for s in steps] == [want] * 3
        assert [s["received"] for s in steps] == [want] * 3
        # the reference's booking: one worker's two hops a bucket
        booked = json.loads(str(rec["programs"]))["gossip"]["gossip_mix|data"]
        assert booked == want - metrics
