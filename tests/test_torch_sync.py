"""Local SGD and post-local SGD in the port (``repro_torch.core.sync``, the
trainer's ``inner_step`` and ``sync_step``), microbatched accumulation and
``eval_step``, against the JAX package.

* The sync rules (which steps aggregate gradients, which average
  parameters) equal the reference's step by step.
* ``average_params`` on a W = 4 stack equals the reference's under
  ``jax.vmap(axis_name="data")``: the ring and rhd schedules bitwise, the
  ``xla`` psum within rtol 1e-6 (another order of the four-way sum), a bf16
  leaf cast back alike; the booked records (kind, payload bytes, tag,
  format) equal the reference's capture.
* The whole slice: ``Trainer.fit`` at W = 4 on the tiny workload against
  the reference's ``run_trainer_scenario(data_par=4)``, run once for the
  module in a subprocess with four host devices: local SGD (H 2),
  post-local SGD (switch 2, H 2, ``qsgd_kernel`` on the int8 compressed
  wire with error feedback) and BSP with 2 microbatches, 4 steps each:
  losses within rtol 1e-4, booked wire per step equal to the reference's
  ``measured["wire_kb_per_step"]``.  Both sides start from the reference's
  ``init_params(cfg, key(0), 1)``; the noise hook replays its key chain.
* In process at W = 1: 2 microbatches and ``eval_step`` against
  ``run_trainer_scenario(microbatch=2, data_par=1)`` and the reference's
  ``eval_step``; local SGD with ``adamw`` and ``clip_norm`` (each worker's
  own gradient clipped on an inner step) against the reference's bundle;
  ``warmup_steps`` accepted and read by nothing, in both packages.
* ``validate`` admits the sync, gossip, pod-local and pipelined fields,
  and raises the reference's ``bundle_spec`` errors on the overlap fields
  and on the churn, rejoin and integrity values it refuses.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comms as jcomms
from repro.core import sync as jsync
from repro.core.types import CommConfig as JCommConfig
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import make_tiny_workload, run_trainer_scenario
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import comms, sync
from repro_torch.core.types import CommConfig, validate
from repro_torch.data.pipeline import BigramSource
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer, wire_per_step

W = 4
Q = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16})
#: (CommConfig fields, microbatch) of each whole-slice cell; lr 0.05, 4 steps
CELLS = {
    "local": (dict(sync="local", local_steps=2), 1),
    "post_local": (dict(sync="post_local", post_local_switch=2, local_steps=2,
                        error_feedback=True, wire_format="compressed", **Q), 1),
    "microbatch": (dict(**Q), 2),
}

REFERENCE = r"""
import json
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import run_trainer_scenario
CELLS = json.loads('CELLS_JSON')
out = {}
for name, (kw, mb) in CELLS.items():
    if "compressor_kwargs" in kw:
        kw["compressor_kwargs"] = tuple(sorted(kw["compressor_kwargs"].items()))
    s = Scenario(n_workers=4, steps=4, bucket_bytes=4e6, lr=0.05, microbatch=mb, **kw)
    r = run_trainer_scenario(s, data_par=4)
    out[name] = {"loss": [float(x) for x in r.series["loss_full"]],
                 "wire_kb": r.measured["wire_kb_per_step"]}
print("REF " + json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for the module.  The tiny workload runs fastest
    so, and the suite's workers share the host, where their thread pools
    would only contend; every port test module imports this fixture."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


def reference_in_subprocess(script: str, cells: dict) -> dict:
    """Run ``script`` (which prints "REF " and a JSON object) with ``cells``
    in a subprocess whose jax has W host devices."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script.replace("CELLS_JSON", json.dumps(cells))],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return json.loads(out.stdout.split("REF ", 1)[1])


@pytest.fixture(scope="module")
def reference_series():
    """Every cell's reference series and wire, from one 4-device subprocess."""
    return reference_in_subprocess(REFERENCE, CELLS)


class _Data:
    """The tiny workload's bigram stream (global batch 64, seq 16)."""

    def __init__(self, shape):
        self.shape, self.src = shape, BigramSource(128, seed=0)

    def batch(self, step):
        return self.src.batch(step, self.shape.global_batch, self.shape.seq_len)


def _noise(step, worker, bucket, n, rnd=None):
    """The reference's draws: key(0) folded with the step, the pipelined
    round (if any), the worker (none for a draw every worker shares) and the
    bucket."""
    key = jax.random.fold_in(jax.random.key(0), step)
    if rnd is not None:
        key = jax.random.fold_in(key, rnd)
    if worker is not None:
        key = jax.random.fold_in(key, worker)
    key = jax.random.fold_in(key, bucket)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def _tiny():
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    return cfg, InputShape("train", 64, 16, "train")


def _reference_params(cfg, device):
    jparams = JT.init_params(make_tiny_workload()[0], jax.random.key(0), 1)
    return interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                     cfg, device)


def port_run(comm, *, n_workers=W, steps=4, lr=0.05, microbatch=1, optimizer=None,
             clip_norm=0.0, device="cpu", noise=_noise, cfg_updates=None, pods=1,
             churn_draws=None):
    """``steps`` of ``Trainer.fit`` on the tiny workload from the reference's
    initial parameters (cast to ``cfg_updates``' parameter dtype, if it
    sets one); returns (bundle, trainer, state, losses)."""
    cfg, shape = _tiny()
    cfg = cfg.with_updates(**(cfg_updates or {}))
    bundle = build_bundle(cfg, comm, optimizer or opt.momentum_sgd(0.0), shape,
                          n_workers=n_workers, seed=0, device=device, noise=noise,
                          clip_norm=clip_norm, microbatch=microbatch, pods=pods,
                          churn_draws=churn_draws)
    tr = Trainer(bundle, _Data(shape), constant(lr), log_every=1)
    state = tr.fit(bundle.init_state(_reference_params(cfg, device)), steps)
    return bundle, tr, state, np.asarray([h["loss"] for h in tr.history])


# ---------------------------------------------------------------------------
# The sync rules and the parameter average.
# ---------------------------------------------------------------------------

RULE_CELLS = [dict(), dict(sync="local", local_steps=3), dict(sync="local", local_steps=1),
              dict(sync="post_local", post_local_switch=3, local_steps=2),
              dict(sync="post_local", post_local_switch=0, local_steps=4)]


@pytest.mark.parametrize("kw", RULE_CELLS, ids=lambda kw: "-".join(map(str, kw.values())) or "bsp")
def test_sync_rules_match_reference(kw):
    comm, jcomm = CommConfig(**kw), JCommConfig(**kw)
    for t in range(12):
        assert sync.grads_need_aggregation(comm, t) == jsync.grads_need_aggregation(jcomm, t)
        assert sync.params_need_sync(comm, t) == jsync.params_need_sync(jcomm, t)


AVG_SHAPES = {"a": (1000,), "b": (37, 11), "c": (4096,), "d": (9000,)}


def _records(log):
    return [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in log.records]


@pytest.mark.parametrize("impl", ["xla", "ring", "rhd"])
def test_average_params_matches_reference_under_vmap(impl):
    rng = np.random.default_rng(7)
    stacks = {k: rng.standard_normal((W, *s)).astype(np.float32) for k, s in AVG_SHAPES.items()}
    stacks["e"] = rng.standard_normal((W, 300)).astype(np.float32)  # held as bf16
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k == "e" else jnp.float32)
               for k, v in stacks.items()}
    # private copies: the port averages in place, and jax may read numpy's
    # memory without a copy (and after the call returns)
    params = {k: torch.tensor(v).to(torch.bfloat16 if k == "e" else torch.float32)
              for k, v in stacks.items()}
    run = jax.jit(jax.vmap(lambda p: jsync.average_params(p, ("data",), impl=impl),
                           axis_name="data"))
    with jcomms.capture() as jlog:
        want = jax.block_until_ready(run(jparams))
    with comms.capture() as log:
        sync.average_params([params[k] for k in sorted(params)], impl=impl)
    assert _records(log) == _records(jlog)
    assert {r.tag for r in log.records} == {"local_sgd_sync"}
    for k in sorted(params):
        w = np.asarray(jnp.asarray(want[k], jnp.float32))
        g = params[k].to(torch.float32).numpy()
        assert (g == g[0]).all()  # every worker holds the average
        if impl == "xla":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_average_params_refuses_churn_arguments():
    """A donor or payload needs the round's alive bits (the churn
    arguments themselves are ported: test_torch_churn_sync.py)."""
    with pytest.raises(ValueError, match="alive"):
        sync.average_params([torch.zeros(W, 3)], donor=torch.ones(W))
    with pytest.raises(ValueError, match="alive"):
        sync.average_params([torch.zeros(W, 3)], payload=lambda i: torch.zeros(W, 3))


# ---------------------------------------------------------------------------
# The whole slice at W = 4 against the reference's trainer.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_sync_slice_matches_reference_trainer(cell, reference_series):
    kw, mb = CELLS[cell]
    bundle, _, _, losses = port_run(CommConfig(bucket_mb=4.0, **kw), microbatch=mb)
    want = reference_series[cell]
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-4)
    assert len(bundle.bucket_plan.buckets) == 1
    assert wire_per_step(bundle, 4) / 1e3 == pytest.approx(want["wire_kb"], rel=1e-12)


def test_local_sgd_rows_agree_after_a_sync_and_differ_between():
    """After the sync step (t = 1 with H 2) every worker holds the same
    parameters; after the next inner step they differ again; the wire books
    no grad_agg under local SGD."""
    comm = CommConfig(sync="local", local_steps=2, bucket_mb=4.0)
    bundle, tr, state, _ = port_run(comm, steps=2)
    for p in state["params"]["embed"].values():
        assert all(torch.equal(p[0], p[w]) for w in range(W))
    state = tr.fit(state, 1, start_step=2)
    p = state["params"]["embed"]["embedding"]
    assert not torch.equal(p[0], p[1])
    assert bundle.wire["inner"].get("grad_agg", 0.0) == 0.0
    assert set(bundle.wire) == {"train", "train_formats", "inner", "inner_formats", "sync",
                                "sync_formats"}


# ---------------------------------------------------------------------------
# W = 1 in process: microbatching, eval_step, adamw + clip_norm, warm-up.
# ---------------------------------------------------------------------------


def test_microbatch_and_eval_match_reference():
    s = Scenario(compressor="qsgd_kernel", compressor_kwargs=(("levels", 16),),
                 error_feedback=True, wire_format="compressed", n_workers=2, steps=3, lr=0.05,
                 bucket_bytes=4e6, microbatch=2)
    ref = run_trainer_scenario(s, data_par=1)
    comm = CommConfig(error_feedback=True, wire_format="compressed", bucket_mb=4.0, **Q)
    bundle, tr, state, losses = port_run(comm, n_workers=1, steps=3, microbatch=2)
    np.testing.assert_allclose(losses, ref.series["loss_full"], rtol=1e-4)
    # eval_step of the reference's own bundle on the same parameters and batch
    cfg, shape, data = make_tiny_workload()
    jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1), JCommConfig(), jopt.sgd(), shape,
                       cache=False)
    jparams = jax.tree.map(jnp.asarray, JT.init_params(cfg, jax.random.key(0), 1))
    batch = data.batch(5)
    want = float(jb.eval_step(jb.init_state(jparams), {k: jnp.asarray(v)
                                                       for k, v in batch.items()}))
    fresh = bundle.init_state(_reference_params(_tiny()[0], "cpu"))
    got = bundle.eval_step(fresh, tr._put(batch))
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(bundle.eval_step(state, tr._put(batch))) < float(got)


def test_local_sgd_inner_steps_clip_each_worker_with_adamw():
    """Local SGD (H 2) with adamw and clip_norm 0.5, 3 steps at W = 1,
    against the reference's own bundle and trainer: the inner step clips the
    worker's own gradient, adamw's step count advances once per step."""
    kw = dict(sync="local", local_steps=2, bucket_mb=4.0)
    cfg, shape, data = make_tiny_workload()
    jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1), JCommConfig(**kw), jopt.adamw(),
                       shape, clip_norm=0.5, seed=0, cache=False)
    jt = JTrainer(jb, data, jconstant(1e-3), log_every=1)
    jt.fit(jt.init(), 3)
    _, _, state, losses = port_run(CommConfig(**kw), n_workers=1, steps=3, lr=1e-3,
                                   optimizer=opt.adamw(), clip_norm=0.5)
    np.testing.assert_allclose(losses, [h["loss"] for h in jt.history], rtol=1e-4)
    assert int(state["opt"]["t"]) == 3


def test_warmup_steps_is_accepted_and_read_by_nothing():
    """One step with warmup_steps=5 equals one with 0, in both packages
    (the reference defines warmup_ratio but its runtime never calls it)."""
    base = dict(compressor="topk", compressor_kwargs={"ratio": 0.05}, error_feedback=True,
                bucket_mb=4.0)
    got = [port_run(CommConfig(warmup_steps=ws, **base), n_workers=1, steps=1)[3]
           for ws in (0, 5)]
    np.testing.assert_array_equal(got[0], got[1])
    cfg, shape, data = make_tiny_workload()
    want = []
    for ws in (0, 5):
        jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1),
                           JCommConfig(warmup_steps=ws, **base), jopt.momentum_sgd(0.0), shape,
                           seed=0, cache=False)
        jt = JTrainer(jb, data, jconstant(0.05), log_every=1)
        jt.fit(jt.init(), 1)
        want.append(jt.history[0]["loss"])
    assert want[0] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# validate.
# ---------------------------------------------------------------------------

ADMITTED = [dict(sync="local", local_steps=4), dict(sync="post_local", post_local_switch=5),
            dict(aggregator="gossip"), dict(aggregator="gossip", gossip_compress="dcd"),
            dict(aggregator="gossip", gossip_compress="choco", compressor="topk",
                 gossip_step_size=0.3, gossip_mix_weight=0.25),
            dict(warmup_steps=10), dict(aggregator="gossip", gossip_graph="exp"),
            # a gossip cell's wire is dense whatever it says, as in the reference
            dict(aggregator="gossip", compressor="topk", wire_format="compressed"),
            dict(pod_local=True), dict(overlap="pipelined")]
#: churn, rejoin and integrity values the reference's bundle_spec refuses
REFUSED = [dict(churn=True, dropout_rate=1.0),
           dict(dropout_rate=-0.1, worker_dropout=(0.1, 1.0)), dict(worker_dropout=(0.1, 2.0)),
           dict(rejoin_policy="pull"), dict(corruption_rate=0.1, corruption_kind="nans"),
           dict(quarantine_limit=0)]


@pytest.mark.parametrize("kw", ADMITTED, ids=str)
def test_validate_admits_sync_and_gossip(kw):
    validate(CommConfig(**kw))


@pytest.mark.parametrize("kw", REFUSED, ids=str)
def test_validate_still_refuses_unported_parts(kw):
    """Each refusal names its field."""
    with pytest.raises(ValueError, match="dropout|rejoin_policy|corruption_kind|quarantine"):
        validate(CommConfig(**kw))


@pytest.mark.parametrize("kw", [dict(sync="ssp"), dict(aggregator="ps"),
                                dict(aggregator="gossip", gossip_compress="sgp")], ids=str)
def test_validate_rejects_unknown_schemes(kw):
    with pytest.raises(ValueError, match="unknown"):
        validate(CommConfig(**kw))


@pytest.mark.parametrize("kw,match", [
    (dict(overlap="bogus"), "unknown overlap mode"),
    (dict(overlap_staleness=2), "must be 0 or 1"),
    (dict(overlap="pipelined", sync="local", local_steps=2), "sync must be bsp"),
    (dict(overlap="pipelined", sync="post_local", post_local_switch=2), "sync must be bsp"),
], ids=str)
def test_validate_raises_the_overlap_errors_of_bundle_spec(kw, match):
    with pytest.raises(ValueError, match=match):
        validate(CommConfig(**kw))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


CARD_CELLS = {
    "local": (CELLS["local"][0], 1, {}),
    # post-local: steps 0, 1 and 3 aggregate (fused EF: qsgd_ef per worker)
    "post_local": (CELLS["post_local"][0], 1, {"qsgd_ef": 3 * 2, "int8_acc": 3}),
    # 2 microbatches on the fused EF path: one aggregation per step
    "microbatch-ef": (dict(error_feedback=True, wire_format="compressed", **Q), 2,
                      {"qsgd_ef": 4 * 2, "int8_acc": 4}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CARD_CELLS))
def test_sync_paths_on_card_launch_their_kernels(cuda, cell):
    """Each cell at W = 2 on the card, 4 steps, launches exactly its
    kernels (one bucket); the losses stay close to the CPU plain path's
    (other sum orders in the model: rtol 1e-3)."""
    kw, mb, kernels = CARD_CELLS[cell]
    comm = CommConfig(bucket_mb=4.0, **kw)
    ops.reset_launches()
    _, _, _, on_card = port_run(comm, n_workers=2, microbatch=mb, device=cuda,
                                noise=lambda *a: _noise(*a).to(cuda))
    assert ops.LAUNCHES == {k: kernels.get(k, 0) for k in ops.LAUNCHES}
    _, _, _, on_cpu = port_run(comm, n_workers=2, microbatch=mb)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
