"""The pipelined step over ranks of the data axis: the tiny workload at W = 4
over R = 2 (and R = 4) gloo processes on the CPU (the tests' harness
``torch_ranked``; torch on one thread in every rank), 2 microbatches, 3
steps at lr 0.05 under ``momentum_sgd(0.9)``, bucket_mb 0.5 (several
buckets), against the same cells stacked in this process.  Over ranks each
round runs on the bundle's communication thread, which owns the transport
while the main thread computes the next microbatch.

* Staleness 0 and 1 under ``qsgd_kernel`` EF (the fused int8 route),
  ``terngrad_kernel`` EF (the 2-bit wire), ``signsgd_packed`` EF (the 1-bit
  wire) and dense f32 on the ``ring`` schedule (its hops sent rank to
  rank); staleness 1 over ``qsgd_kernel`` EF at R = 4.  Bitwise: losses,
  parameters, EF rows, ``overlap_pending`` rows (each rank holding only its
  W/R), the records captured over the run in order and every booked
  program.
* A staleness-1 checkpoint (``overlap_pending`` gathered into the
  reference's (W * size) layout) written at R = 2 and restored stacked,
  and written stacked and restored at R = 2: the arrays equal and the next
  step bitwise the continuous run's.
* The order of events, with 0.5 s injected into every ``torch.distributed``
  call of the ranks' transport (staleness 0): microbatch 1's forward starts
  on the main thread before round 0's first exchange, on the communication
  thread, returns; every round's exchange runs on that thread; and the
  main thread's waits for the rounds (``exposed_s``) stay below the
  seconds inside ``torch.distributed`` (``dist_s``).
* Errors: a round that raises on the communication thread, and a forward
  that raises on the main thread while a round is in flight, each fail
  the ranks promptly (no rank waits for its peer until the group's
  timeout), the error in the rank's output."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore
from repro_torch.core.ranks import RankFailure
from test_torch_ranks import W, cell, check_against_stacked, run_ranked, run_stacked
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import STATE_KEYS, make_cell
from torch_ranked import launch as launch_cells

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=0.5)
ROUTES = {
    "qsgd_ef": Q_EF,
    "tern_ef": dict(compressor="terngrad_kernel", wire_format="compressed",
                    error_feedback=True, bucket_mb=0.5),
    "sign_ef": dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True,
                    bucket_mb=0.5),
    "ring": dict(collective="ring", bucket_mb=0.5),
}


def pipelined(comm: dict, staleness: int) -> dict:
    return dict(comm=dict(comm, overlap="pipelined", overlap_staleness=staleness), microbatch=2)


CELLS = {f"{name}_s{st}": pipelined(kw, st) for name, kw in ROUTES.items() for st in (0, 1)}
CKPT = pipelined(Q_EF, 1)
#: the ordering cell: staleness 0, one bucket, one step, 0.5 s a call
ORDER = dict(pipelined(dict(Q_EF, bucket_mb=32), 0), steps=1, delay=0.5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stacked checkpoint first (the R = 2 launch restores it), then the
    R = 2, R = 4 and ordering launches at once while the stacked twins run
    here."""
    root = tmp_path_factory.mktemp("ranks_pipelined")
    cells = [cell(n, **kw) for n, kw in CELLS.items()]
    stacked = {"ckpt": run_stacked(cell("ckpt", steps=2, save=str(root / "stacked_ckpt"),
                                        **CKPT))}
    two = cells + [cell("ckpt", steps=2, save=str(root / "ranked_ckpt"), **CKPT),
                   cell("restored", steps=1, restore=str(root / "stacked_ckpt"), **CKPT)]
    for d in ("r2", "r4", "order"):
        os.makedirs(root / d)
    with ThreadPoolExecutor(3) as pool:
        launches = {2: pool.submit(run_ranked, two, 2, root / "r2"),
                    4: pool.submit(run_ranked, [cell("qsgd_ef_s1", **CELLS["qsgd_ef_s1"])], 4,
                                   root / "r4"),
                    "order": pool.submit(run_ranked, [cell("order", **ORDER)], 2,
                                         root / "order")}
        stacked.update({c["name"]: run_stacked(c) for c in cells})
        stacked["cont"] = run_stacked(cell("cont", **CKPT))
        ranked = {w: f.result() for w, f in launches.items()}
    return root, stacked, ranked


@pytest.mark.parametrize("name", list(CELLS))
def test_pipelined_over_ranks_matches_stacked(name, runs):
    _, stacked, ranked = runs
    assert np.isfinite(stacked[name]["loss"]).all()
    check_against_stacked(stacked[name], ranked[2][name])
    if name.endswith("_s1"):  # the carried microbatch: each rank its own workers' rows
        for r, rec in enumerate(ranked[2][name]):
            pend = sorted(k for k in rec if k.startswith("overlap_pending/"))
            assert pend and {int(k.rsplit("/", 1)[1]) for k in pend} == {2 * r, 2 * r + 1}
            assert json.loads(str(rec["held"]))["overlap_pending"][0][0] == W // 2
    for rec in ranked[2][name]:  # the rounds ran on the communication thread
        assert json.loads(str(rec["stats"]))["exposed_s"] > 0


def test_pipelined_staleness1_over_four_ranks_matches_stacked(runs):
    _, stacked, ranked = runs
    check_against_stacked(stacked["qsgd_ef_s1"], ranked[4]["qsgd_ef_s1"])


def _tensors(tree) -> dict:
    from repro_torch.utils.tree import flatten_with_paths

    return {k: v for k, v in flatten_with_paths(tree).items() if isinstance(v, torch.Tensor)}


def test_pipelined_checkpoint_from_ranks_restores_stacked_and_back(runs):
    """The R = 2 checkpoint after 2 steps holds the stacked one's arrays
    bitwise, ``overlap_pending`` among them in the (W * size) layout;
    restored stacked, its next step is bitwise the continuous run's third;
    and the stacked checkpoint restored at R = 2 steps to the same bits."""
    root, stacked, ranked = runs
    b = make_cell(cell("x", **CKPT), None, "cpu")[0]
    like = b.checkpoint_like()
    got, gstep = restore(str(root / "ranked_ckpt"), like, "cpu")
    want, wstep = restore(str(root / "stacked_ckpt"), like, "cpu")
    assert gstep == wstep == 2
    g, w = _tensors(got), _tensors(want)
    assert g.keys() == w.keys()
    pend = [k for k in g if k.startswith("comm/overlap_pending")]
    assert pend and all(g[k].shape == (W * s.size,) for k, s in
                        zip(sorted(pend, key=lambda k: int(k.rsplit("/", 1)[1])),
                            b.bucket_plan.buckets))
    assert any(float(g[k].abs().sum()) > 0 for k in pend)
    for k in g:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
    again = run_stacked(cell("again", steps=1, restore=str(root / "ranked_ckpt"), **CKPT))
    cont = stacked["cont"]
    np.testing.assert_array_equal(again["loss"], cont["loss"][2:])
    for k, v in again.items():
        if k.startswith(STATE_KEYS):
            np.testing.assert_array_equal(v, cont[k], err_msg=k)
    check_against_stacked(again, ranked[2]["restored"])


def test_rounds_overlap_the_next_microbatch(runs):
    """With 0.5 s in every exchange: on each rank microbatch 1's forwards
    (main thread) start before round 0's first exchange (communication
    thread) returns; the rounds' calls are all on the communication thread
    and the step's metrics on the main one; exposed_s < dist_s."""
    _, _, ranked = runs
    for rec in ranked["order"]["order"]:
        events = json.loads(str(rec["events"]))
        comm_calls = [e for e in events if e[0] in ("call", "return") and e[1] != "MainThread"]
        main_calls = [e for e in events if e[0] == "call" and e[1] == "MainThread"]
        assert comm_calls and all(e[1].startswith("repro-comm") for e in comm_calls)
        assert len(main_calls) == 3  # the loss, ce and aux gathers, after the rounds
        first_return = next(e[2] for e in comm_calls if e[0] == "return")
        fwd1 = [e[2] for e in events if e[0] == "forward" and e[3] == 1]
        assert len(fwd1) == W // 2 and all(e[1] == "MainThread" for e in events
                                           if e[0] == "forward")
        assert max(fwd1) < first_return, (fwd1, first_return)
        last_round = max(e[2] for e in comm_calls)
        assert all(e[2] > last_round for e in main_calls)
        stats = json.loads(str(rec["stats"]))
        assert 0 < stats["exposed_s"] < stats["dist_s"], stats


@pytest.mark.parametrize("fail, message", [
    ({"fail_round": [1, 1]}, "injected round failure at step 1, round 1, on repro-comm"),
    ({"fail_forward": 6}, "injected forward failure on MainThread"),
])
def test_an_error_in_either_thread_fails_the_ranks(fail, message, tmp_path):
    """Staleness 1: round 1 of step 1 raises on the communication thread
    (the main thread reads it when it next waits for the round); or the
    forward of step 1's second microbatch raises on the main thread while
    that step's round 1 is in flight (the main thread lets the round end
    first, so the peer's exchange completes).  Both ranks fail, well inside
    the launch's time limit, each with the error."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"cells": [cell("fail", **CKPT, **fail)], "threads": 1,
                                "device": "cpu"}))
    with pytest.raises(RankFailure) as e:
        launch_cells(str(spec), str(tmp_path), 2, timeout=120, env={"OMP_NUM_THREADS": "1"})
    assert "a rank failed" in str(e.value) and message in str(e.value), str(e.value)[-3000:]
