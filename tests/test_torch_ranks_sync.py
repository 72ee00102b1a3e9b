"""Local, post-local and pod-local SGD over ranks of the data axis: the tiny
workload at W = 4 over R = 2 and R = 4 gloo processes on the CPU (the
tests' harness ``torch_ranked``; torch on one thread in every rank), 3
steps at lr 0.05 under ``momentum_sgd(0.9)`` (post-local SGD 4, so that
its fourth step both aggregates and averages), against the same cells
stacked in this process.

* Local SGD (H 2) under the ``xla``, ``ring`` and ``rhd`` averages;
  post-local SGD (switch 2, H 2) and pod-local SGD at one pod (its one row
  stands for all W workers), both over ``qsgd_kernel`` EF (a gathered
  route: the f32 ``dense`` sum adds the ranks' partials, within rtol 1e-6,
  test_torch_ranks_routes.py); ZeRO-1 under local SGD
  (the rows made equal by its all-gather, as the reference); local SGD
  with a binding ``clip_norm`` (each worker's own gradient clipped).
  Bitwise: losses, every parameter and optimizer row (each held by some
  rank), EF and momentum rows, the records captured over the run and
  every booked program; each rank holds only its W/R rows of the
  parameters and of their momentum (pod-local SGD's one row on every
  rank).
* The bytes a rank sends a step: its three metrics to the other ranks,
  and on the sync step the average's: the ``xla`` sum gathers the rank's
  W/R rows of every leaf to the R - 1 others, (R - 1)(W/R) n 4 bytes; the
  ring sends 2(W - 1)(m/W) 4 bytes a leaf of m elements padded to a
  multiple of W, rhd 2 (W/R) m (R - 1)/R 4 (its halving and doubling
  steps over the bits above the rank's own), each to the byte.
* Checkpoints of local SGD (H 3, so that the rows diverge when written
  after 2 steps): written at R = 2 and restored stacked, written stacked
  and restored at R = 2, the arrays equal and the next step (the
  average) bitwise the continuous run's."""

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore
from repro_torch.core.collectives import padded_len
from repro_torch.models import transformer as T
from repro_torch.utils.tree import leaves
from test_torch_ranks import W, cell, check_against_stacked, run_ranked, run_stacked
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import STATE_KEYS, make_cell

LOCAL = dict(sync="local", local_steps=2)
Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=0.5)
#: name -> (cell keys, diverging parameter rows)
CELLS = {
    "local_xla": (dict(comm=LOCAL), W),
    "local_ring": (dict(comm=dict(LOCAL, collective="ring")), W),
    "local_rhd": (dict(comm=dict(LOCAL, collective="rhd")), W),
    "post_local_qsgd_ef": (dict(comm=dict(sync="post_local", post_local_switch=2,
                                          local_steps=2, **Q_EF), steps=4), W),
    "pod_local_qsgd_ef": (dict(comm=dict(pod_local=True, local_steps=2, **Q_EF)), 1),
    "local_zero1": (dict(comm=LOCAL, zero1=True), W),
    "local_clip": (dict(comm=LOCAL, clip_norm=0.05), W),
}
CKPT = dict(comm=dict(sync="local", local_steps=3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stacked twins in this process while the R = 2 and R = 4 launches
    run (the stacked checkpoint first: the R = 2 launch restores it)."""
    root = tmp_path_factory.mktemp("ranks_sync")
    cells = [cell(n, **kw) for n, (kw, _) in CELLS.items()]
    stacked = {"ckpt": run_stacked(cell("ckpt", steps=2, save=str(root / "stacked_ckpt"),
                                        **CKPT))}
    two = cells + [cell("ckpt", steps=2, save=str(root / "ranked_ckpt"), **CKPT),
                   cell("restored", steps=1, restore=str(root / "stacked_ckpt"), **CKPT)]
    os.makedirs(root / "r2"), os.makedirs(root / "r4")
    with ThreadPoolExecutor(2) as pool:
        launches = {2: pool.submit(run_ranked, two, 2, root / "r2"),
                    4: pool.submit(run_ranked, cells, 4, root / "r4")}
        stacked.update({c["name"]: run_stacked(c) for c in cells})
        stacked["cont"] = run_stacked(cell("cont", **CKPT))
        ranked = {w: f.result() for w, f in launches.items()}
    return root, stacked, ranked


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CELLS))
def test_sync_scheme_over_ranks_matches_stacked(name, world, runs):
    _, stacked, ranked = runs
    assert np.isfinite(stacked[name]["loss"]).all()
    check_against_stacked(stacked[name], ranked[world][name], rows=CELLS[name][1])


def test_clip_binds_and_zero1_makes_the_rows_equal(runs):
    """The clipped cell parts from its unclipped twin; ZeRO-1 under local
    SGD leaves every worker's row equal (its all-gather hands each worker
    the same concatenation), the plain local cell does not."""
    _, stacked, _ = runs
    params = [k for k in stacked["local_xla"] if k.startswith("param/")]
    assert any(not np.array_equal(stacked["local_clip"][k], stacked["local_xla"][k])
               for k in params)
    for name, equal in (("local_zero1", True), ("local_xla", False)):
        rows = {k.rsplit("/", 1)[0] for k in params}
        same = all(np.array_equal(stacked[name][f"{p}/{w}"], stacked[name][f"{p}/0"])
                   for p in rows for w in range(W))
        assert same == equal, name


def _leaf_sizes() -> list[int]:
    cfg = make_cell(cell("x", **CELLS["local_xla"][0]), None, "cpu")[0].cfg
    return [math.prod(d.shape) for d in leaves(T.param_defs(cfg))]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["local_xla", "local_ring", "local_rhd"])
def test_sync_step_moves_the_schedules_bytes(name, world, runs):
    """Each rank's bytes a step: 12 (W/R)(R - 1) for the loss, ce and aux
    gathers, and on the sync step (the second) the average's, to the
    byte; as many received."""
    _, _, ranked = runs
    k, metrics = W // world, 3 * 4 * (W // world) * (world - 1)
    avg = 0
    for n in _leaf_sizes():
        m = padded_len(n, W)
        avg += {"local_xla": (world - 1) * k * n * 4,
                "local_ring": 2 * (W - 1) * (m // W) * 4,
                "local_rhd": 2 * k * m * (world - 1) // world * 4}[name]
    for rec in ranked[world][name]:
        steps = json.loads(str(rec["step_stats"]))
        assert [s["sent"] for s in steps] == [metrics, metrics + avg, metrics]
        assert [s["received"] for s in steps] == [s["sent"] for s in steps]


def _tensors(tree) -> dict:
    from repro_torch.utils.tree import flatten_with_paths

    return {k: v for k, v in flatten_with_paths(tree).items() if isinstance(v, torch.Tensor)}


def test_local_sgd_checkpoint_from_ranks_restores_stacked_and_back(runs):
    """The R = 2 checkpoint after 2 inner steps holds the stacked one's
    arrays bitwise (every worker's parameter and momentum rows gathered,
    the rows apart); restored stacked, its next step (the average) is
    bitwise the continuous run's third; and the stacked checkpoint
    restored at R = 2 steps to the same bits."""
    root, stacked, ranked = runs
    b = make_cell(cell("x", **CKPT), None, "cpu")[0]
    like = b.checkpoint_like()
    got, gstep = restore(str(root / "ranked_ckpt"), like, "cpu")
    want, wstep = restore(str(root / "stacked_ckpt"), like, "cpu")
    assert gstep == wstep == 2
    g, w = _tensors(got), _tensors(want)
    assert g.keys() == w.keys()
    for k in g:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
    p = g["params/embed/embedding"]
    assert p.shape[0] == W and not torch.equal(p[0], p[1])  # diverged rows, all W
    again = run_stacked(cell("again", steps=1, restore=str(root / "ranked_ckpt"), **CKPT))
    cont = stacked["cont"]
    np.testing.assert_array_equal(again["loss"], cont["loss"][2:])
    for k, v in again.items():
        if k.startswith(STATE_KEYS):
            np.testing.assert_array_equal(v, cont[k], err_msg=k)
    check_against_stacked(again, ranked[2]["restored"], rows=W)
