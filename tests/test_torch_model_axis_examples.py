"""The two example twins on the reference's data 4 x model 2 layout,
against the reference's own runs at 3 steps (the examples run 120 and 200;
tests/test_torch_quickstart.py runs the quickstart twin whole):

* compression_comparison: its first 4 cells here (dense, QSGD at 4 and 16
  levels, TernGrad; the other 4 in
  test_torch_model_axis_examples2.py) through ``run_trainer_sweep(...,
  data_par=4, model_par=2)``, as the twin calls it, against the
  reference's, from the reference's ``init_params(cfg, key(0), 2)`` with
  its key chain replayed: each final loss within rtol 1e-4 and the wire per
  step equal.
* quickstart: its bundle (top-k 5%, error feedback, momentum correction
  0.9, 4 MB buckets; 4 workers x 2 model shards, seq 64, batch 16) under
  its warmup-cosine schedule against the reference example's bundle on a
  4 x 2 mesh: losses within rtol 1e-4, the booked train wire by tag equal.
One 8-device subprocess runs the reference for the module."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import interop
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.examples import compression_comparison, quickstart
from repro_torch.experiments import trainer_substrate as P
from repro_torch.optim.optimizers import momentum_sgd
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_sync import _noise, _one_thread  # noqa: F401

STEPS = 3

REFERENCE = r"""
import dataclasses, json, sys
import jax, numpy as np
from repro.configs.base import InputShape
from repro.core.types import CommConfig
from repro.data.pipeline import BigramSource
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import make_tiny_workload, run_trainer_sweep
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import warmup_cosine
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
from repro.utils.tree import flatten_with_paths
OUT, CELLS, STEPS, QUICK = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg, _, _ = make_tiny_workload()
np.savez(OUT, **{k: np.asarray(v, np.float32) for k, v in
                 flatten_with_paths(JT.init_params(cfg, jax.random.key(0), 2)).items()})
cells = []
for kw in CELLS:
    if kw.get("compressor_kwargs"):
        kw["compressor_kwargs"] = tuple(tuple(x) for x in kw["compressor_kwargs"])
    cells.append(Scenario(**kw))
res, _ = run_trainer_sweep(cells, data_par=4, model_par=2)
out = {"cells": [{"loss": r.measured["final_loss"], "wire_kb": r.measured["wire_kb_per_step"]}
                 for r in res]}
if QUICK != "quickstart":
    print("REF " + json.dumps(out))
    sys.exit(0)
shape = InputShape("train", seq_len=64, global_batch=16, kind="train")
comm = CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.05}, error_feedback=True,
                  momentum_correction=0.9, bucket_mb=4)
b = build_bundle(cfg, make_test_mesh(data=4, model=2), comm, momentum_sgd(0.0), shape)
src = BigramSource(cfg.vocab, seed=0)
class Data:
    def batch(self, step): return src.batch(step, shape.global_batch, shape.seq_len)
t = Trainer(b, Data(), warmup_cosine(0.1, 20, 200), log_every=1)
t.fit(t.init(), STEPS)
out["quickstart"] = {"loss": [h["loss"] for h in t.history], "wire": b.wire["train"]}
print("REF " + json.dumps(out))
"""


def cells(part: slice):
    return [(name, dataclasses.replace(s, steps=STEPS))
            for name, s in compression_comparison.CELLS[part]]


def run_reference(path, part: slice, quick: bool) -> tuple[dict, dict]:
    cs = [dataclasses.asdict(s) for _, s in cells(part)]
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path), json.dumps(cs),
                          str(STEPS), "quickstart" if quick else "-"],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1]), dict(np.load(path))


def check_cells(part: slice, ref: dict, flat: dict) -> None:
    params = interop.params_from_numpy(flat, P.make_tiny_workload()[0], "cpu", 2)
    got = cells(part)
    res, skipped = P.run_trainer_sweep([s for _, s in got], data_par=4, model_par=2,
                                       device="cpu", params=params, noise=_noise)
    assert not skipped
    for (name, _), r, want in zip(got, res, ref["cells"]):
        np.testing.assert_allclose(r.measured["final_loss"], want["loss"], rtol=1e-4,
                                   err_msg=name)
        assert r.measured["wire_kb_per_step"] == want["wire_kb"], name


PART = slice(0, 4)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("model_axis_examples") / "params.npz", PART,
                         quick=True)


def test_compression_comparison_cells_match_reference(reference):
    check_cells(PART, *reference)


def test_quickstart_bundle_matches_reference(reference):
    ref, flat = reference
    cfg = P.make_tiny_workload()[0]
    shape = InputShape("train", seq_len=64, global_batch=16, kind="train")
    comm = CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.05}, error_feedback=True,
                      momentum_correction=0.9, bucket_mb=4)
    b = build_bundle(cfg, comm, momentum_sgd(0.0), shape, n_workers=quickstart.WORKERS,
                     device="cpu", model=quickstart.MODEL, cache=False)
    src = BigramSource(cfg.vocab, seed=0)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    t = Trainer(b, Data(), warmup_cosine(0.1, 20, 200), log_every=1)
    t.fit(b.init_state(interop.params_from_numpy(flat, cfg, "cpu", 2)), STEPS)
    np.testing.assert_allclose([h["loss"] for h in t.history], ref["quickstart"]["loss"],
                               rtol=1e-4)
    assert b.wire["train"] == ref["quickstart"]["wire"]
