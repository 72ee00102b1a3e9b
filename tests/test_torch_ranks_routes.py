"""Every reduction route of ``aggregate.bucket_route`` over ranks of the
data axis: the tiny workload at W = 4 over R = 2 and R = 4 gloo processes
on the CPU, 3 steps at lr 0.01 under ``momentum_sgd``, against the same
cell stacked in this process (``test_torch_ranks.check_against_stacked``).

Bitwise (losses, parameters, EF and momentum rows, every rank's parameters
against rank 0's) where the stacked route gathers rows and reduces them in
worker order: the int8 codes (``fused_ef``, ``int8_acc``), the 1-bit and
2-bit wires, the bf16 wire (``widen``), the bf16 ``xla`` sum (its rows kept
and added in worker order after the gather), the ring and rhd schedules,
``gather`` (sparse scatter-add and ``sign_unpack`` decode) and
``majority``'s int8 vote sum.  Where a running f32 sum over a rank's
workers is added to the other ranks' partials (``reduce_partial``: the f32
``dense`` and ``sum`` routes and PowerSGD's two factor sums), the losses
and parameters within rtol 1e-6 (atol 1e-6 x the largest magnitude) and
the state rows, which carry three steps of that drift, within atol 1e-4 x
their largest magnitude.  The records captured over each run
and the booked train program equal the stacked run's on every rank.  The
ring and rhd schedules send their hops between the ranks: a rank's bytes a
step are its three metrics' gathers and, a bucket padded to m elements of
s bytes, the ring's 2(W - 1)(m/W) s, rhd's 2 (W/R) m (R - 1)/R s, to the
byte."""

import json

import numpy as np
import pytest

from repro_torch.core.aggregate import bucket_route
from repro_torch.core.collectives import padded_len
from repro_torch.core.compression.base import get_compressor
from repro_torch.core.types import CommConfig
from test_torch_ranks import W, cell, check_against_stacked, run_ranked, run_stacked
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import make_cell

CW = dict(wire_format="compressed")
#: name -> (CommConfig fields, the route, bitwise); bucket_mb 0.5 (several buckets)
ROUTES = {
    "dense_f32": (dict(), "dense", False),
    "dense_bf16": (dict(agg_dtype="bfloat16"), "dense", True),
    "ring_f32": (dict(collective="ring"), "dense", True),
    "rhd_bf16": (dict(collective="rhd", agg_dtype="bfloat16"), "dense", True),
    "widen": (dict(**CW), "widen", True),
    "powersgd_ef": (dict(compressor="powersgd", compressor_kwargs={"rank": 2},
                         error_feedback=True), "powersgd", False),
    "qsgd_kernel_ef": (dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                            error_feedback=True, **CW), "fused_ef", True),
    "qsgd_kernel": (dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, **CW),
                    "int8_acc", True),
    "qsgd_twin_momentum_ef": (dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                                   momentum_correction=0.9, error_feedback=True, **CW),
                              "int8_acc", True),
    "signsgd_packed_ef": (dict(compressor="signsgd_packed", error_feedback=True, **CW), "sign",
                          True),
    "signsgd_vote": (dict(compressor="signsgd", **CW), "sign", True),
    "terngrad_kernel_ef": (dict(compressor="terngrad_kernel", error_feedback=True, **CW), "tern",
                           True),
    "majority": (dict(compressor="signsgd"), "majority", True),
    "topk_ef": (dict(compressor="topk", compressor_kwargs={"ratio": 0.05},
                     error_feedback=True), "gather", True),
    "signsgd_packed_dense": (dict(compressor="signsgd_packed"), "gather", True),
    "threshold_ef": (dict(compressor="threshold", compressor_kwargs={"tau": 1e-3},
                          error_feedback=True), "sum", False),
}


def _cell(name: str) -> dict:
    return cell(name, comm=dict(bucket_mb=0.5, **ROUTES[name][0]), lr=0.01)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_routes")
    cells = [_cell(n) for n in ROUTES]
    stacked = {c["name"]: run_stacked(c) for c in cells}
    return stacked, {world: run_ranked(cells, world, root) for world in (2, 4)}


def test_every_route_is_covered():
    routes = set()
    for kw, route, _ in ROUTES.values():
        comm = CommConfig(**kw)
        comp = get_compressor(comm.compressor, **comm.compressor_kwargs)
        assert bucket_route(comm, comp) == route
        routes.add(route)
    assert routes == {"dense", "widen", "powersgd", "fused_ef", "int8_acc", "sign", "tern",
                      "majority", "gather", "sum"}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ROUTES))
def test_route_over_ranks_matches_stacked(name, world, runs):
    stacked, ranked = runs
    rec = stacked[name]
    assert np.isfinite(rec["loss"]).all() and W % world == 0
    check_against_stacked(rec, ranked[world][name], bitwise=ROUTES[name][2])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["ring_f32", "rhd_bf16"])
def test_schedule_sends_its_hops_between_the_ranks(name, world, runs):
    _, ranked = runs
    k, size = W // world, 4 if name == "ring_f32" else 2
    hops = 0
    for b in make_cell(_cell(name), None, "cpu")[0].bucket_plan.buckets:
        m = padded_len(b.size, W)
        hops += (2 * (W - 1) * (m // W) * size if name == "ring_f32"
                 else 2 * k * m * (world - 1) // world * size)
    want = 3 * 4 * k * (world - 1) + hops
    for rec in ranked[world][name]:
        steps = json.loads(str(rec["step_stats"]))
        assert [s["sent"] for s in steps] == [s["received"] for s in steps] == [want] * 3
