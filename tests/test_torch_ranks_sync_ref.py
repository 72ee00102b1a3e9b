"""The sync schemes and gossip over ranks against the reference: D-PSGD,
local SGD (H 2) on the ``ring`` schedule and CHOCO-SGD with
``qsgd_kernel`` (16 levels), the tiny workload at W = 4 over R = 2 gloo
processes on the CPU, against the reference's ``Trainer`` at data 4 on
forced host devices (one 4-device subprocess running the three cells in
turn), 3 steps at lr 0.05 (CHOCO-SGD 0.01, as test_torch_gossip.py
holds it: at 0.05 a QSGD level flips between the packages' f32 inputs at
the third step, stacked or ranked alike) under ``momentum_sgd(0.9)`` from
the reference's ``init_params(cfg, key(0), 1)``.  The reference's key chain
reaches the ranks as a table of its draws (``torch_ranked.table_noise``;
CHOCO-SGD's one draw a bucket that every worker shares), recorded from the
stacked port's run under ``test_torch_sync._noise``.  Losses within rtol
1e-4, and the programs the run books (the gossip step; local SGD's inner
and sync steps) by (tag, axes) equal to the reference's capture of its run
to the byte, on both ranks; the ranks hold the stacked run's losses and
parameters bitwise."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.experiments.trainer_substrate import make_tiny_workload as jtiny
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from test_torch_ranks import W, cell, run_ranked, run_stacked
from test_torch_ranks_ref import REFERENCE
from test_torch_sync import _noise, _one_thread  # noqa: F401

#: name -> (CommConfig fields, lr, the programs its run books)
CELLS = {
    "dpsgd": (dict(aggregator="gossip", bucket_mb=0.5), 0.05, ("gossip",)),
    "local_ring": (dict(sync="local", local_steps=2, collective="ring"), 0.05,
                   ("inner", "sync")),
    "choco_qsgd_kernel": (dict(aggregator="gossip", gossip_compress="choco",
                               compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                               bucket_mb=0.5), 0.01, ("gossip",)),
}
STEPS = 3
#: the reference's script run once for each cell, in one process
SCRIPT = ("import sys\nfor kw, lr in zip(sys.argv[5::2], sys.argv[6::2]):\n"
          "    sys.argv[1], sys.argv[3] = kw, lr\n"
          + "\n".join("    " + ln for ln in REFERENCE.strip().splitlines()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_sync_ref")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", SCRIPT, "", str(W), "", str(STEPS),
                            *(a for kw, lr, _ in CELLS.values() for a in (json.dumps(kw), str(lr)))],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        params = root / "params.npz"
        np.savez(params, **{k: np.asarray(v, np.float32) for k, v in jflatten(
            JT.init_params(jtiny()[0], jax.random.key(0), 1)).items()})
        import torch_ranked

        stacked, cells = {}, []
        for name, (kw, lr, _) in CELLS.items():
            draws = {}

            def recording(step, worker, bucket, n, rnd=None, draws=draws):
                u = _noise(step, worker, bucket, n, rnd)
                draws[f"{step}/{worker}/{bucket}"] = u.numpy()
                return u

            c = cell(name, comm=kw, lr=lr, steps=STEPS, params=str(params))
            real = torch_ranked.table_noise
            torch_ranked.table_noise = lambda path, device, rec=recording: rec
            try:  # the stacked run records the draws
                stacked[name] = run_stacked(dict(c, noise="recorded"))
            finally:
                torch_ranked.table_noise = real
            table = root / f"noise_{name}.npz"
            np.savez(table, **draws)
            cells.append(dict(c, noise=str(table)))
        got = run_ranked(cells, 2, root)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    refs = [json.loads(ln.split("REF ", 1)[1]) for ln in out.splitlines() if ln.startswith("REF ")]
    assert len(refs) == len(CELLS)
    return dict(zip(CELLS, refs)), stacked, got


@pytest.mark.parametrize("name", list(CELLS))
def test_scheme_over_ranks_matches_reference_losses(name, runs):
    ref, stacked, ranked = runs
    np.testing.assert_allclose(stacked[name]["loss"], ref[name]["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranked[name][0]["loss"], ref[name]["loss"], rtol=1e-4)
    np.testing.assert_array_equal(ranked[name][0]["loss"], stacked[name]["loss"])


@pytest.mark.parametrize("name", list(CELLS))
def test_scheme_over_ranks_books_the_reference_wire(name, runs):
    ref, _, ranked = runs
    wire = {k: v for k, v in ref[name]["wire"].items() if v}  # model axis of size 1: 0 B
    assert wire
    for rec in ranked[name]:
        programs = json.loads(str(rec["programs"]))
        got: dict[str, float] = {}
        for prog in CELLS[name][2]:
            for k, v in programs[prog].items():
                got[k] = got.get(k, 0.0) + v
        assert {k: v for k, v in got.items() if v} == wire


@pytest.mark.parametrize("name", list(CELLS))
def test_scheme_over_ranks_is_the_stacked_run(name, runs):
    _, stacked, ranked = runs
    for r, rec in enumerate(ranked[name]):  # each rank its own W/R rows
        rows = [k for k in rec if k.startswith("param/")]
        assert rows and all(int(k.rsplit("/", 1)[1]) // (W // 2) == r for k in rows)
        for k in rows:
            np.testing.assert_array_equal(rec[k], stacked[name][k], err_msg=k)
