"""The tests' harness for ranks on the data axis: many small training
cells in one launch of R rank processes, each process recording what it
ends with, held against the same cells stacked (the user's entry point is
``python -m repro_torch.launch.train --ranks R``; this harness adds the
tiny workload, the reference's initial parameters and noise draws, and a
record of every array each rank holds).

    python -m torch_ranked SPEC.json OUT_DIR     # tests/ on PYTHONPATH

runs as one process per rank (started by :func:`launch`, which sets
``RANK``, ``WORLD_SIZE`` and the store), or as one stacked process when the
spec says ``"ranked": false``.  It runs every cell of ``SPEC["cells"]`` on
``SPEC["device"]`` in turn and writes ``OUT_DIR/<cell>.<rank>.npz`` (rank
``stacked`` for the stacked run): :func:`run_cell`'s record.

A cell is a dict, on ``make_tiny_workload``'s model and bigram data:
``name``; ``workers``, ``steps``, ``lr``, ``seed``; ``comm`` (CommConfig
fields); ``opt`` ("sgd", "momentum" with ``momentum``, or "adamw"),
``zero1``, ``clip_norm``, ``microbatch``; ``params`` (an npz of the initial
parameters by path, else ``init_params(seed)``); ``noise`` (an npz of the
uniform draws by "step/worker/bucket[/round]", else the seeded default);
``churn`` (an npz of each worker's two churn uniforms, mask and corruption,
by "step/worker[/round]", else the seeded default); ``restore`` and
``save`` (checkpoint directories read before and written after the
steps); ``eval`` (one ``eval_step`` on the next batch after them);
``delay`` (seconds: every ``torch.distributed`` call of the ranks'
transport slowed by that much, inside its counted seconds, and the
record's ``events`` holding, in order, each call's start and return and
each microbatch's forward start, with the thread that made it);
``fail_round`` ([step, round]: the compressors' draws of that pipelined
round raise) and ``fail_forward`` (n: the n-th forward of the run raises),
errors injected into the communication thread and the main thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core import ranks as R
from repro_torch.core.ranks import RankGroup, close_group, init_group
from repro_torch.core.types import CommConfig
from repro_torch.utils.tree import flatten_with_paths


@dataclass
class DelayedGroup(RankGroup):
    """A rank group whose every ``torch.distributed`` call waits ``delay``
    seconds first (counted in ``dist_s``), logging its start and return in
    ``events`` with its thread's name."""

    delay: float = 0.0
    events: list = field(default_factory=list)

    def _call(self, fn, *args):
        name = threading.current_thread().name
        self.events.append(["call", name, time.perf_counter()])

        def slow(*a):
            time.sleep(self.delay)
            return fn(*a)

        out = super()._call(slow, *args)
        self.events.append(["return", name, time.perf_counter()])
        return out


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def draw_key(step, worker, *rest) -> str:
    """A draw's key in a table: "step/worker[/bucket][/round]" (a round of
    None left out; a worker of None, a draw every worker shares, kept)."""
    return "/".join([str(step), str(worker), *(str(x) for x in rest if x is not None)])


def table_noise(path: str, device):
    """A noise hook that reads its draws from an npz keyed
    "step/worker/bucket[/round]"."""
    with np.load(path) as z:
        table = {k: z[k] for k in z.files}

    def noise(step, worker, bucket, n, rnd=None):
        key = draw_key(step, worker, bucket, rnd)
        a = table[key]
        if a.shape != (n,):
            raise ValueError(f"noise table {key}: {a.shape}, want ({n},)")
        return torch.from_numpy(a).to(device)

    return noise


def table_churn(path: str, device):
    """A churn_draws hook that reads each worker's (mask, corruption)
    uniforms from an npz keyed "step/worker[/round]"."""
    with np.load(path) as z:
        table = {k: z[k] for k in z.files}

    def churn_draws(step, worker, rnd=None):
        a = torch.from_numpy(table[draw_key(step, worker, rnd)]).to(device)
        return a[0], a[1]

    return churn_draws


def recording(noise=None, churn_draws=None) -> tuple:
    """Each hook wrapped to record its draws as a table (``noise``:
    "step/worker/bucket[/round]" -> the draws; ``churn_draws``:
    "step/worker[/round]" -> the two uniforms): (noise, churn_draws,
    {"noise": ..., "churn": ...}), the tables as numpy arrays for
    ``np.savez``, which :func:`table_noise` and :func:`table_churn` read."""
    tables: dict[str, dict[str, np.ndarray]] = {"noise": {}, "churn": {}}

    def rec_noise(step, worker, bucket, n, rnd=None):
        u = noise(step, worker, bucket, n, rnd)
        tables["noise"][draw_key(step, worker, bucket, rnd)] = u.cpu().numpy()
        return u

    def rec_churn(step, worker, rnd=None):
        u = churn_draws(step, worker, rnd)
        tables["churn"][draw_key(step, worker, rnd)] = np.array([float(u[0]), float(u[1])],
                                                                np.float32)
        return u

    return (rec_noise if noise else None), (rec_churn if churn_draws else None), tables


def make_cell(cell: dict, group: RankGroup | None, device):
    """The cell's bundle, trainer and data."""
    from repro_torch.core import aggregate
    from repro_torch.experiments.trainer_substrate import make_tiny_workload
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.schedules import constant
    from repro_torch.train.steps import build_bundle
    from repro_torch.train.trainer import Trainer

    cfg, shape, data = make_tiny_workload()
    kind = cell.get("opt", "momentum")
    opt = (O.sgd() if kind == "sgd" else O.adamw() if kind == "adamw"
           else O.momentum_sgd(cell.get("momentum", 0.9)))
    W = cell.get("workers", 4)
    if cell.get("zero1"):
        opt = O.zero1(opt, W)
    noise = table_noise(cell["noise"], device) if cell.get("noise") else None
    churn = (table_churn(cell["churn"], device) if cell.get("churn")
             else aggregate.seeded_churn_draws(cell.get("seed", 0), device))
    drawn: list[list] = []

    def churn_draws(step, worker, rnd=None):  # records which workers this process drew
        drawn.append([step, worker, rnd])
        return churn(step, worker, rnd)

    bundle = build_bundle(cfg, CommConfig(**cell.get("comm", {})), opt, shape, n_workers=W,
                          seed=cell.get("seed", 0), device=device, noise=noise,
                          clip_norm=cell.get("clip_norm", 0.0),
                          microbatch=cell.get("microbatch", 1), cache=False, ranks=group,
                          churn_draws=churn_draws)
    bundle.drawn = drawn
    return bundle, Trainer(bundle, data, constant(cell.get("lr", 0.05)), log_every=1), cfg


def _rows(prefix: str, t: torch.Tensor, workers: range) -> dict[str, torch.Tensor]:
    return {f"{prefix}/{w}": row for w, row in zip(workers, t)}


def run_cell(cell: dict, group: RankGroup | None, device: str | torch.device
             ) -> dict[str, Any]:
    """Run ``cell`` on this process (its rank's workers under ``group``):
    returns its record, by key: ``loss`` (the logged series, rank 0 and the
    stacked run; and ``kept``, the masked sparsifiers' kept share; ``eval``,
    the ``eval_step`` loss, on every rank), ``param/<path>`` (diverging
    parameters by row, ``param/<path>/<row>``, for the rows this process
    holds), ``ef/<bucket>/<worker>`` and ``u/<bucket>/<worker>`` for the
    workers this process holds, ``opt/<path>`` (ZeRO-1's rows as
    ``opt/<path>/<worker>``, a diverging parameter's state as
    ``opt/<path>/<row>``), ``records`` (JSON: the booked records captured
    over the run), ``booked`` (JSON: the bundle's train program by
    "tag|axes", {} for gossip), ``programs`` (JSON: every booked program's,
    by name), ``stats`` (JSON: the bytes and seconds the rank moved over the
    steps), ``step_stats`` (JSON: the same, step by step), ``launches``
    (JSON: the kernels this process launched over the steps), ``seconds``
    (JSON: the host seconds of the build and initial state, the steps, and
    the record) and ``held`` (JSON: the shapes of the ``ef``, ``u`` and
    CHOCO stacks, and of the parameters and their optimizer state, this
    process holds).  Arrays are raw (bf16 as int16)."""
    from repro_torch import interop
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    if cell.get("delay") and group is not None:
        group = DelayedGroup(group.world, group.rank, group.n_workers, group.device,
                             delay=cell["delay"])
    bundle, tr, cfg = make_cell(cell, group, device)
    events = group.events if isinstance(group, DelayedGroup) else None
    if events is not None:  # each microbatch's forward start, with its thread
        real = bundle._grads

        def grads(params, part, microbatch, tag=None):
            events.append(["forward", threading.current_thread().name, time.perf_counter(), tag])
            return real(params, part, microbatch, tag)

        bundle._grads = grads
    if cell.get("fail_round") is not None:  # the round's draws raise, on its thread
        noise, at = bundle.noise, tuple(cell["fail_round"])

        def failing_noise(step, worker, bucket, n, rnd=None):
            if (step, rnd) == at:
                raise RuntimeError(f"injected round failure at step {step}, round {rnd}, "
                                   f"on {threading.current_thread().name}")
            return noise(step, worker, bucket, n, rnd)

        bundle.noise = failing_noise
    if cell.get("fail_forward") is not None:  # the n-th forward raises
        real_grads, calls = bundle._grads, [0]

        def failing_grads(*a, **kw):
            calls[0] += 1
            if calls[0] > cell["fail_forward"]:
                raise RuntimeError(f"injected forward failure on "
                                   f"{threading.current_thread().name}")
            return real_grads(*a, **kw)

        bundle._grads = failing_grads
    start = 0
    if cell.get("restore"):
        state, start = tr.restore(cell["restore"])
    elif cell.get("params"):
        with np.load(cell["params"]) as z:
            flat = {k: z[k] for k in z.files}
        state = bundle.init_state(interop.params_from_numpy(flat, cfg, device))
    else:
        state = tr.init(cell.get("seed", 0))
    t1 = time.perf_counter()
    bundle.drawn.clear()
    ops.reset_launches()
    step_stats = []
    with comms.capture() as log:
        for t in range(start, start + cell.get("steps", 3)):
            before = group.stats.snapshot() if group else {}
            state = tr.fit(state, 1, start_step=t)
            after = group.stats.snapshot() if group else {}
            step_stats.append({k: after[k] - before[k] for k in after})
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    moved = group.stats.snapshot() if group else {}  # over the steps alone
    t2 = time.perf_counter()
    if cell.get("save"):
        tr.save(cell["save"], state, start + cell.get("steps", 3))
    evals = (float(bundle.eval_step(state, tr._put(tr.data.batch(start + cell.get("steps", 3)))))
             if cell.get("eval") else None)
    workers = bundle.workers
    rows = range(bundle.row_start, bundle.row_start + bundle.held_rows)
    arrays: dict[str, torch.Tensor] = {}
    for k, v in flatten_with_paths(state["params"]).items():
        if bundle.stacked:  # diverging parameters: the rows this process holds
            arrays.update(_rows(f"param/{k}", v, rows))
        else:
            arrays[f"param/{k}"] = v
    for k in COMM_STACKS:
        for i, e in enumerate(state["comm"].get(k, ())):
            if e is not None:
                arrays.update(_rows(f"{k}/{i}", e, workers))
    for k in WORKER_VECTORS:  # the churn and integrity vectors, by worker
        if k in state["comm"]:
            arrays.update(_rows(k, state["comm"][k], workers))
    for k, v in flatten_with_paths(state["opt"]).items():
        if bundle.opt.n_shards and v.ndim:  # ZeRO-1's (W, k) rows: this process's
            arrays.update(_rows(f"opt/{k}", v, workers))
        elif bundle.stacked and v.ndim:  # a diverging row's state
            arrays.update(_rows(f"opt/{k}", v, rows))
        else:
            arrays[f"opt/{k}"] = v
    out: dict[str, Any] = {}
    for k, v in arrays.items():
        out[k] = _host(v)
    out["loss"] = np.asarray([h["loss"] for h in tr.history], np.float64)
    if evals is not None:
        out["eval"] = np.float64(evals)
    if any("kept" in h for h in tr.history):
        out["kept"] = np.asarray([h["kept"] for h in tr.history], np.float64)
    out["records"] = np.array(json.dumps([dataclasses.asdict(r) for r in log.records]))
    programs = {name: by_tag_axes(plog.records) for name, plog in bundle.logs.items()}
    out["booked"] = np.array(json.dumps(programs.get("train", {})))
    out["programs"] = np.array(json.dumps(programs))
    out["stats"] = np.array(json.dumps(moved))
    out["step_stats"] = np.array(json.dumps(step_stats))
    out["launches"] = np.array(json.dumps(launches))
    out["seconds"] = np.array(json.dumps({"build": t1 - t0, "fit": t2 - t1,
                                          "record": time.perf_counter() - t2}))
    held = {k: [None if e is None else list(e.shape) for e in state["comm"].get(k, ())]
            for k in COMM_STACKS}
    held.update({k: [list(state["comm"][k].shape)] for k in WORKER_VECTORS
                 if k in state["comm"]})
    out["drawn"] = np.array(json.dumps(bundle.drawn))
    if events is not None:
        out["events"] = np.array(json.dumps(events))
    held["params"] = [list(v.shape) for v in flatten_with_paths(state["params"]).values()]
    held["opt"] = [list(v.shape) for v in flatten_with_paths(state["opt"]).values() if v.ndim]
    out["held"] = np.array(json.dumps(held))
    return out


def by_tag_axes(records) -> dict[str, float]:
    """Booked wire bytes by "tag|axes"."""
    out: dict[str, float] = {}
    for r in records:
        key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
        out[key] = out.get(key, 0.0) + r.wire_bytes * r.mult
    return out


#: the comm state's per-worker stacks (rows by bucket) and vectors
COMM_STACKS = ("ef", "u", "choco_xhat", "choco_nbr", "overlap_pending")
WORKER_VECTORS = ("alive_prev", "pod_alive_prev", "qcount", "quarantine_total",
                  "escalation_total")
#: the record keys of the state a process holds; of them, the per-worker ones
PER_WORKER = tuple(f"{k}/" for k in COMM_STACKS + WORKER_VECTORS)
STATE_KEYS = ("param/", "opt/") + PER_WORKER


def differences(stacked: dict, ranked: list[dict]) -> list[str]:
    """Where a ranked run's records part from its stacked twin's, bitwise
    (empty: none): the loss series (rank 0 logs), every state array each
    rank holds (and every stacked one held by a rank), every rank's
    parameters against rank 0's where both hold them, and the records
    booked and captured over the run."""
    out = []
    if not np.array_equal(ranked[0]["loss"], stacked["loss"]):
        out.append(f"loss {ranked[0]['loss'].tolist()} != {stacked['loss'].tolist()}")
    held = {k for rec in ranked for k in rec if k.startswith(STATE_KEYS)}
    out += [f"no rank holds {k}" for k in stacked if k.startswith(STATE_KEYS) and k not in held]
    for r, rec in enumerate(ranked):
        for k, v in rec.items():
            if k.startswith(STATE_KEYS) and not np.array_equal(v, stacked.get(k)):
                out.append(f"rank {r} {k}")
            if k.startswith("param/") and k in ranked[0] and not np.array_equal(v, ranked[0][k]):
                out.append(f"rank {r} {k} != rank 0's")
        for k in ("records", "booked", "programs"):
            if json.loads(str(rec[k])) != json.loads(str(stacked[k])):
                out.append(f"rank {r} {k}")
    return out


def load(out_dir: str, cell: str, tag) -> dict:
    with np.load(os.path.join(out_dir, f"{cell}.{tag}.npz")) as z:
        return {k: z[k] for k in z.files}


TESTS = os.path.dirname(os.path.abspath(__file__))


def launch(spec: str, out_dir: str, world: int, *, timeout: float,
           env: dict | None = None) -> list[str]:
    """This module over ``world`` rank processes (:func:`repro_torch.core.ranks.launch`,
    with ``tests/`` on their path)."""
    env = dict(env or {})
    env["PYTHONPATH"] = TESTS + (os.pathsep + os.environ["PYTHONPATH"]
                                 if os.environ.get("PYTHONPATH") else "")
    return R.launch("torch_ranked", [spec, out_dir], world, timeout=timeout, env=env)


def twins(cells: list[dict], world: int, out_dir: str, *, timeout: float,
          env: dict | None = None, **spec) -> dict[str, tuple[dict, list[dict]]]:
    """Each cell stacked in one process and over ``world`` ranks (two
    launches at once, the same ``spec`` keys: device, deterministic,
    threads): {cell: (stacked record, each rank's)}; the launches'
    outputs go to ``out_dir/twins.log``."""
    from concurrent.futures import ThreadPoolExecutor

    def run(ranked: bool, n: int) -> list[str]:
        path = os.path.join(out_dir, f"twins_{'ranked' if ranked else 'stacked'}.json")
        with open(path, "w") as f:
            json.dump({**spec, "cells": cells, "ranked": ranked}, f)
        return launch(path, out_dir, n, timeout=timeout, env=env)

    with ThreadPoolExecutor(2) as pool:  # the twins run at once, each in its own processes
        runs = [pool.submit(run, False, 1), pool.submit(run, True, world)]
        logs = runs[0].result() + runs[1].result()
    with open(os.path.join(out_dir, "twins.log"), "w") as f:
        f.write("\n".join(logs))
    return {c["name"]: (load(out_dir, c["name"], "stacked"),
                        [load(out_dir, c["name"], r) for r in range(world)]) for c in cells}


#: when this module was imported (so a cell's line shows the process's set-up)
T0 = time.perf_counter()


def main(argv: list[str] | None = None) -> int:
    spec_path, out_dir = argv if argv is not None else sys.argv[1:]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", torch.get_num_threads()))
    device = spec["device"]
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    base = init_group(spec["cells"][0].get("workers", 4), device) if spec.get("ranked", True) \
        else None
    tag = "stacked" if base is None else str(base.rank)
    try:
        for cell in spec["cells"]:
            group = (None if base is None else
                     dataclasses.replace(base, n_workers=cell.get("workers", 4),
                                         stats=type(base.stats)()))
            dev = device if group is None else group.device
            t0 = time.perf_counter()
            rec = run_cell(cell, group, dev)
            np.savez(os.path.join(out_dir, f"{cell['name']}.{tag}.npz"), **rec)
            print(f"cell {cell['name']} rank {tag}: {time.perf_counter() - t0:.1f} s "
                  f"{rec['seconds']} (since import {time.perf_counter() - T0:.1f} s); loss "
                  f"{rec['loss'].tolist()} stats {rec['stats']}", flush=True)
    finally:
        close_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
