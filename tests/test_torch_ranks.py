"""Ranks on the data axis (``repro_torch.core.ranks``): the W = 4 workers
of the tiny workload (``make_tiny_workload``) spread over R = 2 and R = 4
gloo processes on the CPU (the tests' harness ``torch_ranked``, started
by ``ranks.launch``; torch on one thread in every rank), 3 steps, against
the same cells stacked in this process.

* The main path and the optimizers: ``qsgd_kernel`` on the int8 compressed
  wire with error feedback under ``momentum_sgd``, ``zero1``, ``adamw``
  with ``clip_norm`` (binding), and ``sgd`` with 2 microbatches on the
  ternary wire; ``eval_step`` after the main path's steps.  Losses,
  parameters, EF and momentum rows and ZeRO-1's slices bitwise; every
  rank's parameters bitwise rank 0's; every rank's
  records captured over the run equal to the stacked run's, and the
  booked train program too; each rank holds only its W/R rows of ``ef``
  and ``u``; the bytes each rank sent and received are the int8 codes,
  norms and metrics of its own workers, to the byte.
* Checkpoints: written at R = 2, restored stacked, and written stacked,
  restored at R = 2: the arrays equal, and the next step bitwise the
  continuous run's.
* The entry point: ``python -m repro_torch.launch.train --ranks 2 --device
  cpu`` against ``--ranks 1``, its stacked twin, for the main path under
  ZeRO-1 and for local SGD (H 2): the checkpoints each writes at its end
  equal bitwise, and the ``rank-stats`` lines' losses, captured wire and
  ``--digest`` digests (those of the arrays written) equal.
* Each option ranks refuse raises a ``ValueError`` naming its later slice
  (the model and pod axes, slice 26, also under the pipelined step and
  churn, which ranks run since slices 24-25);
  the launcher fails with every rank's output when a rank fails or the
  ranks overrun their time limit.

The routes (``bucket_route``) are in test_torch_ranks_routes.py, the main
path against the reference's ``Trainer`` in test_torch_ranks_ref.py, the
sync schemes and gossip in test_torch_ranks_sync.py,
test_torch_ranks_gossip.py and test_torch_ranks_sync_ref.py, the pipelined
step in test_torch_ranks_pipelined.py, churn and integrity in
test_torch_ranks_churn.py and test_torch_ranks_churn_ref.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore
from repro_torch.checkpoint.ckpt import digest
from repro_torch.configs.base import InputShape
from repro_torch.core.ranks import RankFailure, RankGroup, launch
from repro_torch.core.types import CommConfig
from repro_torch.experiments.trainer_substrate import make_tiny_workload
from repro_torch.optim import optimizers as opt
from repro_torch.train.steps import build_bundle, build_serve
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import COMM_STACKS, PER_WORKER, STATE_KEYS, WORKER_VECTORS, make_cell, run_cell
from torch_ranked import launch as launch_cells

W = 4
Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=0.5)
TERN_EF = dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True,
               bucket_mb=0.5)
#: the cells of this module, 3 steps each, lr 0.05 unless they say
CELLS = {
    "qsgd_ef": dict(comm=Q_EF, eval=True),
    "zero1": dict(comm=Q_EF, zero1=True),
    "adamw_clip": dict(comm=Q_EF, opt="adamw", clip_norm=0.05, lr=1e-3),
    "sgd_microbatch": dict(comm=TERN_EF, opt="sgd", microbatch=2),
}
CKPT = dict(comm=Q_EF, zero1=True)


def cell(name: str, **kw) -> dict:
    return {"name": name, "workers": W, "steps": 3, **kw}


def run_stacked(c: dict) -> dict:
    """``c`` stacked in this process, on the CPU."""
    return run_cell(c, None, "cpu")


def run_ranked(cells: list[dict], world: int, out_dir, timeout: float = 240.0) -> dict:
    """Every cell at ``world`` ranks: {cell name: [each rank's record]}."""
    spec = os.path.join(out_dir, f"spec{world}.json")
    with open(spec, "w") as f:
        json.dump({"cells": cells, "threads": 1, "device": "cpu"}, f)
    launch_cells(spec, str(out_dir), world, timeout=timeout, env={"OMP_NUM_THREADS": "1"})
    return {c["name"]: [dict(np.load(os.path.join(out_dir, f"{c['name']}.{r}.npz")))
                        for r in range(world)] for c in cells}


def check_against_stacked(stacked: dict, ranked: list[dict], bitwise: bool = True,
                          rows: int = 0) -> None:
    """A ranked run's records against its stacked twin's: the loss series
    (rank 0 logs), every state array each rank holds, and every one of the
    stacked run's held by some rank, the parameters of every rank against
    rank 0's bitwise where both hold them, the records captured and every
    program booked; each rank holds its own W/R workers' rows of ``ef``,
    ``u`` and the CHOCO mirrors, and, with ``rows`` diverging parameter
    rows (W, or 1 under pod-local SGD at one pod), its own rows of the
    parameters and of their optimizer state (W/R, or the one row); so for
    ``overlap_pending`` and the churn and integrity vectors.  Not
    ``bitwise`` (a running f32 sum over each rank's workers): the losses
    and parameters within rtol 1e-6 (atol 1e-6 x the array's largest
    magnitude); the optimizer, EF and momentum rows carry three steps of the
    sums' drift through the gradients (threshold EF's rows 2.0e-5 x their
    largest magnitude apart, PowerSGD's momentum 1.9e-6), held within rtol
    1e-6 and atol 1e-4 x the largest magnitude."""
    world = len(ranked)

    def same(got, want, what):
        if bitwise:
            np.testing.assert_array_equal(got, want, err_msg=what)
            return
        top = float(np.max(np.abs(want), initial=0.0))
        scale = 1e-6 if what == "loss" or " param/" in what else 1e-4
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=scale * top, err_msg=what)

    same(ranked[0]["loss"], stacked["loss"], "loss")
    assert ("kept" in ranked[0]) == ("kept" in stacked)
    for rec in ranked if "eval" in stacked else ():  # eval_step's worker mean, every rank
        same(rec["eval"], stacked["eval"], "loss")
    if "kept" in stacked:  # the masked sparsifiers' kept share over all W
        same(ranked[0]["kept"], stacked["kept"], "loss")
    held_keys = {k for rec in ranked for k in rec if k.startswith(STATE_KEYS)}
    assert held_keys == {k for k in stacked if k.startswith(STATE_KEYS)}
    per_worker = PER_WORKER
    for r, rec in enumerate(ranked):
        own = range(r * W // world, (r + 1) * W // world)
        for k, v in rec.items():
            if k.startswith(STATE_KEYS):
                same(v, stacked[k], f"rank {r} {k}")
            if k.startswith("param/") and k in ranked[0]:
                np.testing.assert_array_equal(v, ranked[0][k], err_msg=f"rank {r} {k}")
        got_rows = {k for k in rec if k.startswith(per_worker)}
        want_rows = {k for k in stacked if k.startswith(per_worker)
                     and int(k.rsplit("/", 1)[1]) in own}
        assert got_rows == want_rows, f"rank {r} holds {sorted(got_rows)[:4]}"
        held = json.loads(str(rec["held"]))
        for k in COMM_STACKS + WORKER_VECTORS:
            assert all(s is None or s[0] == W // world for s in held.get(k, ())), (k, held[k])
        if rows:  # the diverging parameters and their state: this rank's rows
            want = W // world if rows == W else rows
            for k in ("params", "opt"):
                assert held[k] and all(s[0] == want for s in held[k]), (k, held[k][:3])
        for k in ("records", "booked", "programs"):
            assert json.loads(str(rec[k])) == json.loads(str(stacked[k])), k
    assert all(r["loss"].size == 0 for r in ranked[1:])  # only rank 0 logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stacked twins (and the stacked checkpoint the R = 2 run restores)
    in this process, then one launch at R = 2 and one at R = 4."""
    root = tmp_path_factory.mktemp("ranks")
    cells = [cell(n, **kw) for n, kw in CELLS.items()]
    stacked = {c["name"]: run_stacked(c) for c in cells}
    stacked["cont"] = run_stacked(cell("cont", **CKPT))
    stacked["ckpt"] = run_stacked(cell("ckpt", steps=2, save=str(root / "stacked_ckpt"), **CKPT))
    two = cells + [cell("ckpt", steps=2, save=str(root / "ranked_ckpt"), **CKPT),
                   cell("restored", steps=1, restore=str(root / "stacked_ckpt"), **CKPT)]
    ranked = {2: run_ranked(two, 2, root), 4: run_ranked(cells, 4, root)}
    return root, stacked, ranked


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CELLS))
def test_ranks_match_stacked(name, world, runs):
    _, stacked, ranked = runs
    check_against_stacked(stacked[name], ranked[world][name])


@pytest.mark.parametrize("world", [2, 4])
def test_bytes_moved_are_the_ranks_own_rows(world, runs):
    """qsgd_kernel EF: a step moves each rank's int8 codes and f32 norms of
    every bucket and its loss, ce and aux, to the W - W/R workers of the
    other ranks, and receives as many."""
    _, _, ranked = runs
    bundle = make_cell(cell("qsgd_ef", **CELLS["qsgd_ef"]), None, "cpu")[0]
    sizes = [b.size for b in bundle.bucket_plan.buckets]
    assert len(sizes) > 1
    per_step = (world - 1) * (W // world) * (sum(sizes) + 4 * len(sizes) + 3 * 4)
    for rec in ranked[world]["qsgd_ef"]:
        stats = json.loads(str(rec["stats"]))
        assert stats["sent"] == stats["received"] == 3 * per_step
        assert stats["calls"] == 3 * (2 * len(sizes) + 3) and stats["staged"] == 0


def _tensors(tree) -> dict:
    from repro_torch.utils.tree import flatten_with_paths

    return {k: v for k, v in flatten_with_paths(tree).items() if isinstance(v, torch.Tensor)}


def test_checkpoint_from_ranks_restores_stacked_and_back(runs):
    """The R = 2 checkpoint holds the stacked one's arrays bitwise (the
    per-worker rows gathered into the reference's layout); restored
    stacked, its next step is bitwise the continuous run's third; and the
    stacked checkpoint restored at R = 2 steps to the same bits."""
    root, stacked, ranked = runs
    b = make_cell(cell("x", **CKPT), None, "cpu")[0]
    like = b.checkpoint_like()
    got, gstep = restore(str(root / "ranked_ckpt"), like, "cpu")
    want, wstep = restore(str(root / "stacked_ckpt"), like, "cpu")
    assert gstep == wstep == 2
    g, w = _tensors(got), _tensors(want)
    assert g.keys() == w.keys() and any(k.startswith("comm/ef") for k in g)
    for k in g:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
    again = run_stacked(cell("again", steps=1, restore=str(root / "ranked_ckpt"), **CKPT))
    cont = stacked["cont"]
    np.testing.assert_array_equal(again["loss"], cont["loss"][2:])
    for k, v in again.items():
        if k.startswith(STATE_KEYS):
            np.testing.assert_array_equal(v, cont[k], err_msg=k)
    check_against_stacked(again, ranked[2]["restored"])


def _group(n_workers: int = W) -> RankGroup:
    return RankGroup(2, 0, n_workers, torch.device("cpu"))


REFUSED = {
    "pod_local": (dict(pod_local=True, local_steps=2), {"pods": 2}, "slice 26"),
    "pod_local_pods4": (dict(pod_local=True, local_steps=2), {"pods": 4}, "slice 26"),
    "model": (dict(), {"model": 2}, "slice 26"),
    "pods": (dict(), {"pods": 2}, "slice 26"),
    "pipelined_model": (dict(overlap="pipelined"), {"microbatch": 2, "model": 2}, "slice 26"),
    "churn_pods": (dict(dropout_rate=0.25), {"pods": 2}, "slice 26"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_ranks_refuse_later_slices(name):
    kw, build, slice_no = REFUSED[name]
    cfg, shape, _ = make_tiny_workload()
    with pytest.raises(ValueError, match=slice_no):
        build_bundle(cfg, CommConfig(**kw), opt.sgd(), shape, n_workers=W, device="cpu",
                     cache=False, ranks=_group(), **build)


def test_ranks_refuse_serving_and_a_mismatched_group():
    cfg, shape, _ = make_tiny_workload()
    with pytest.raises(ValueError, match="slice 27"):
        build_serve(cfg, InputShape("serve", 16, 2, "serve"), "cpu", ranks=_group())
    with pytest.raises(ValueError, match="splits 8 workers"):
        build_bundle(cfg, CommConfig(), opt.sgd(), shape, n_workers=W, device="cpu",
                     cache=False, ranks=_group(8))
    with pytest.raises(ValueError, match="do not split"):
        RankGroup(3, 0, W, torch.device("cpu"))


#: launch.train's arguments for its CPU runs: qwen3-0.6b reduced, the main
#: path (qsgd_kernel EF) under ZeRO-1, 3 steps
TRAIN = ["--arch", "qwen3-0.6b", "--reduced", "--workers", str(W), "--device", "cpu",
         "--comm", "qsgd_kernel_ef", "--zero1", "--steps", "3", "--global-batch", "8",
         "--seq-len", "16"]
#: the same, local SGD averaging every 2 steps (no ZeRO-1)
TRAIN_LOCAL = [a for a in TRAIN if a != "--zero1"]
TRAIN_LOCAL[TRAIN_LOCAL.index("qsgd_kernel_ef")] = "local_sgd"
TRAIN_LOCAL += ["--local-steps", "2"]
#: the pipelined step at staleness 1 under churn and integrity (no ZeRO-1)
TRAIN_PIPE = [a for a in TRAIN if a != "--zero1"]
TRAIN_PIPE[TRAIN_PIPE.index("qsgd_kernel_ef")] = "churn_qsgd"
TRAIN_PIPE += ["--overlap", "pipelined", "--overlap-staleness", "1", "--microbatch", "2"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _train(ranks: int, ckpt, args: list[str] = TRAIN) -> list[dict]:
    """``python -m repro_torch.launch.train *args --ranks ranks``, its end
    state checkpointed under ``ckpt`` and digested: each process's
    ``rank-stats`` line, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--ranks", str(ranks), "--ckpt-dir", str(ckpt), "--ckpt-every", "3",
                          "--digest"],
                         capture_output=True, text=True, timeout=240, env=env)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    stats = [json.loads(ln.split("rank-stats ", 1)[1]) for ln in run.stdout.splitlines()
             if ln.startswith("rank-stats ")]
    assert [s["rank"] for s in stats] == list(range(ranks)), run.stdout[-4000:]
    return stats


def test_launch_train_over_ranks_is_its_stacked_twin(tmp_path):
    """The entry point at --ranks 2 and --ranks 1 (stacked), at once, for
    the main path under ZeRO-1, for local SGD (H 2) and for the pipelined
    step under churn and integrity: the checkpoints of
    their end states equal bitwise, and rank 0's digests of it the stacked
    run's and those of the arrays written; rank 0's loss series the stacked
    one's, every rank's captured wire the stacked run's, each rank sent and
    received bytes and the stacked run none (local SGD: its metrics on the
    inner steps, its rows' gather on the sync step and for the checkpoint);
    and for ``churn_qsgd`` under the pipelined step at staleness 1, its
    ``overlap_pending`` and churn tallies among the arrays, the ranks' churn
    tallies a step adding up to the stacked run's."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(6) as pool:
        runs = [pool.submit(_train, r, tmp_path / f"ranks{r}") for r in (1, 2)]
        local = [pool.submit(_train, r, tmp_path / f"local{r}", TRAIN_LOCAL) for r in (1, 2)]
        pipe = [pool.submit(_train, r, tmp_path / f"pipe{r}", TRAIN_PIPE) for r in (1, 2)]
        (stacked,), ranked = runs[0].result(), runs[1].result()
        _check_twin(tmp_path / "local1", tmp_path / "local2", local[0].result()[0],
                    local[1].result(), "local_sgd_sync|data", ("params/", "opt/"))
        (pipe1,), pipe2 = pipe[0].result(), pipe[1].result()
        _check_twin(tmp_path / "pipe1", tmp_path / "pipe2", pipe1, pipe2, "grad_agg|data",
                    ("comm/ef", "comm/overlap_pending", "comm/quarantine_total", "opt/"))
    # the churn tallies a step: the ranks' own workers' add up to the stacked run's
    assert [{k: sum(t[k] for t in ts) for k in ts[0]}
            for ts in zip(*(st["tallies"] for st in pipe2))] == pipe1["tallies"]
    assert sum(t["quarantined"] for t in pipe1["tallies"]) > 0
    assert all(st["per_step"]["exposed_s"] > 0 for st in pipe2)  # the rounds' thread
    for st in local[1].result():  # 12 B a metric; the sync step gathers the rows too (and
        sent = st["sent_per_step"]  # the last, the checkpoint's)
        assert sent[0] == 24 < sent[1] and st["received_per_step"] == sent
    _check_twin(tmp_path / "ranks1", tmp_path / "ranks2", stacked, ranked, "grad_agg|data",
                ("comm/ef", "opt/"))


def _check_twin(stacked_dir, ranked_dir, stacked: dict, ranked: list[dict], wire_key: str,
                kinds: tuple[str, ...]) -> None:
    assert len(stacked["loss"]) == 3 and np.isfinite(stacked["loss"]).all()
    assert ranked[0]["loss"] == stacked["loss"] and ranked[1]["loss"] == []
    for st in ranked:
        assert st["wire"] == stacked["wire"] and wire_key in st["wire"]
        assert st["workers"] == [st["rank"] * 2, st["rank"] * 2 + 2]
        assert st["per_step"]["sent"] == st["per_step"]["received"] > 0
    assert stacked["per_step"] == {} and stacked["workers"] == [0, W]
    for d in (stacked_dir, ranked_dir):
        manifest = json.loads((d / "step3" / "manifest.json").read_text())
        assert manifest["step"] == 3
    with np.load(stacked_dir / "step3" / "arrays.npz") as a, \
            np.load(ranked_dir / "step3" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for kind in kinds:
            assert any(k.startswith(kind) for k in a.files), kind
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert digest({k: a[k] for k in a.files}) == stacked["digest"]
    assert ranked[0]["digest"] == stacked["digest"] and ranked[1]["digest"] is None


def test_launcher_fails_with_every_ranks_output(tmp_path):
    """A failing rank fails the launch, and so does an overrun; the error
    holds each rank's output."""
    env = {"OMP_NUM_THREADS": "1"}
    with pytest.raises(RankFailure) as e:
        launch("repro_torch.launch.train", ["--arch", "no-such-model", "--ranks", "2",
                                            "--device", "cpu"], 2, timeout=120, env=env)
    msg = str(e.value)  # the first rank to fail stops the other
    assert "--- rank 0 ---" in msg and "--- rank 1 ---" in msg
    assert "a rank failed" in msg and "unknown arch 'no-such-model'" in msg
    with pytest.raises(RankFailure, match="overran"):
        launch("repro_torch.launch.train", [*TRAIN, "--steps", "500", "--ranks", "2"], 2,
               timeout=3, env=env)
