"""The port's model axis on its own (``msize`` M: the layers' M shards
stacked in one process), without a reference run.

* The TP identity, as tests/test_tp_equivalence.py holds the reference to
  it: the same padded-for-M parameters and one batch give, at model-axis
  size M and at 1, the objective ce + coef * aux within 2e-4 relative and
  the squared global gradient norm within 5e-3 relative, for all ten
  configurations (``reduced()``) at M = 2, and at the reference's M = 4
  with its padded-head variants (qwen3-0.6b with 6 query heads over 2 KV
  heads, MHA qwen1.5-32b with 6, hymba-1.5b with 5).
* The sharding plan: every leaf's sharded dimension and shard-local shape
  equal the reference's ``PartitionSpec`` and ``local_abstract`` on a
  (data, model) mesh, for each full configuration at M = 2 and 4.
* The booked model-axis records of a step: per layer and in the loss, by
  formula from the shapes (qwen3-0.6b reduced at W = 2 x M = 2).
* ZeRO-1 under the axis: its state is (W, M, k) per leaf and the step
  equals the unsharded optimizer's.
* What stays refused: serving at M > 1 (``build_serve``, ``launch/serve.py
  --model 2``) with a message naming slice 20; churn, PowerSGD and the
  pipelined step under the axis.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import comms
from repro_torch.core.types import CommConfig
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.sharding import local_defs
from repro_torch.optim import optimizers as opt
from repro_torch.train.steps import build_bundle, build_serve
from repro_torch.utils.tree import flatten_with_paths, leaves, unflatten_like
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = ("qwen3-0.6b", "qwen1.5-32b", "glm4-9b", "gemma3-12b", "qwen2-vl-2b",
         "seamless-m4t-large-v2", "rwkv6-3b", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "deepseek-v2-lite-16b")
#: the reference's M = 4 variants (tests/test_tp_equivalence.py)
PADDED = {"qwen3-0.6b": {"n_heads": 6, "n_kv_heads": 2, "d_model": 6 * 32, "head_dim": 32},
          "qwen1.5-32b": {"n_heads": 6, "n_kv_heads": 6, "d_model": 6 * 32, "head_dim": 32},
          "hymba-1.5b": {"n_heads": 5, "n_kv_heads": 5, "d_model": 5 * 32, "head_dim": 32,
                         "ssm_expand": 2.0}}
CASES = ([(a, 2, {}) for a in ARCHS] + [(a, 4, PADDED.get(a, {})) for a in ARCHS])


def _objective_and_grad2(cfg, params, batch, msize):
    ps = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    loss, m = T.forward_loss(cfg, unflatten_like(params, ps), batch, msize=msize,
                             use_kernel=False)
    grads = torch.autograd.grad(loss, ps)
    full = float((m["ce"] + cfg.router_aux_coef * m["aux"]).detach())
    return full, sum(float(torch.sum(torch.square(g.double()))) for g in grads)


@pytest.mark.parametrize("arch,msize,upd", CASES,
                         ids=[f"{a}-m{m}{'-padded' if u else ''}" for a, m, u in CASES])
def test_tp_identity(arch, msize, upd):
    cfg = get_config(arch).reduced().with_updates(**upd)
    params = T.init_params(cfg, 0, "cpu", msize)  # padded-for-M shapes
    rng = np.random.default_rng(1)
    B, S = 4, 32
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int64))
             for k in ("tokens", "labels")}
    if cfg.modality == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal((B, 8, cfg.d_model))
                                            .astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal((B, 8, cfg.d_model))
                                           .astype(np.float32))
    l1, g1 = _objective_and_grad2(cfg, params, batch, 1)
    lm, gm = _objective_and_grad2(cfg, params, batch, msize)
    assert abs(l1 - lm) < 2e-4 * max(1.0, abs(l1)), (l1, lm)
    assert abs(g1 - gm) < 5e-3 * max(1.0, abs(g1)), (g1, gm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("msize", (2, 4))
def test_shard_dims_and_local_shapes_match_reference(arch, msize):
    from repro.models.sharding import make_plan
    from repro.train.steps import local_abstract

    class Mesh:  # local_abstract reads only the axis sizes
        shape = {"data": 1, "model": msize, "pod": 1}

    jabs, jspecs, _ = JT.abstract_params(jget(arch), msize)
    jloc = jflatten(local_abstract(jabs, jspecs, Mesh()))
    specs = {k: d.spec for k, d in jflatten(JT.build_defs(jget(arch),
                                                         make_plan(jget(arch), msize))).items()}
    defs = flatten_with_paths(T.param_defs(get_config(arch), msize))
    loc = flatten_with_paths(local_defs(T.param_defs(get_config(arch), msize), msize))
    assert list(defs) == list(jloc)
    for path, d in defs.items():
        want = [i for i, e in enumerate(specs[path]) if e == "model"]
        assert ([d.shard] if d.shard is not None else []) == want, path
        assert tuple(loc[path].shape) == tuple(jloc[path].shape), path


def _tiny(vocab=128):
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=vocab, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    return cfg, InputShape("train", 16, 8, "train")


def test_booked_model_axis_records_match_formula():
    """Per layer: the attention's and the MLP's row-parallel psums of one
    shard's (b, S, d) partial; in the loss a pmax and two psums of (b, S)
    f32 and the embedding's psum; the fix-up psum of each replicated
    leaf's gradient (the norms); b the worker's rows, the compute dtype."""
    cfg, shape = _tiny()
    W, M = 2, 2
    b = build_bundle(cfg, CommConfig(), opt.sgd(), shape, n_workers=W, device="cpu", model=M,
                     cache=False)
    bl, S, d = shape.global_batch // W, shape.seq_len, cfg.d_model
    act = bl * S * d * torch.finfo(cfg.dtype).bits // 8
    emb = bl * S * d * torch.finfo(cfg.pdtype).bits // 8
    vec = bl * S * 4
    want_untagged = (2 * cfg.n_layers * act + emb + 3 * vec)
    model_recs = [r for r in b.logs["train"].records if r.axes == ("model",)]
    got = sum(r.payload_bytes * r.mult for r in model_recs if not r.tag)
    assert got == want_untagged
    defs = flatten_with_paths(T.param_defs(cfg, M))
    fix = sum(int(np.prod(x.shape)) * torch.finfo(cfg.pdtype).bits // 8
              for x in defs.values() if x.shard is None)
    assert sum(r.payload_bytes for r in model_recs if r.tag == "tp_grad_fixup") == fix
    assert all(r.n_workers == M and r.kind in ("psum", "pmax") for r in model_recs)


def test_zero1_state_and_step_under_model_axis():
    cfg, shape = _tiny(256)
    W, M = 2, 2
    params = T.init_params(cfg, 0, "cpu", M)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (8, 16))) for k in ("tokens", "labels")}
    out = []
    for o in (opt.momentum_sgd(0.9), opt.zero1(opt.momentum_sgd(0.9), W)):
        b = build_bundle(cfg, CommConfig(), o, shape, n_workers=W, device="cpu", model=M,
                         cache=False)
        st = b.init_state(params)
        for _ in range(2):
            st, _ = b.train_step(st, batch, 0.1)
        out.append((b, st))
    (b0, s0), (b1, s1) = out
    for p0, p1 in zip(leaves(s0["params"]), leaves(s1["params"])):
        torch.testing.assert_close(p1, p0, rtol=1e-6, atol=1e-7)
    loc = leaves(local_defs(T.param_defs(cfg, M), M))
    for v, d in zip(s1["opt"]["inner"]["v"], loc):
        assert v.shape == (W, M, -(-int(np.prod(d.shape)) // W))
    ck = b1.checkpoint_tree(s1)["opt"]["inner"]["v"]
    assert sum(x.numel() for x in leaves(ck)) == sum(v.numel() for v in s1["opt"]["inner"]["v"])
    assert b1.wire["train"]["zero1_gather"] > 0


def test_serving_and_unported_options_refused():
    cfg, shape = _tiny()
    with pytest.raises(NotImplementedError, match="slice 20"):
        build_serve(cfg, InputShape("s", 32, 2, "decode"), "cpu", msize=2)
    with pytest.raises(NotImplementedError, match="slice 20"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--model", "2"])
    with pytest.raises(NotImplementedError, match="slice 20"):
        T.check_serving(cfg, 2)
    for comm, what in ((CommConfig(dropout_rate=0.1), "churn"),
                       (CommConfig(compressor="powersgd"), "PowerSGD"),
                       (CommConfig(overlap="pipelined", overlap_staleness=0), "pipelined")):
        with pytest.raises(NotImplementedError, match=what):
            build_bundle(cfg, comm, opt.sgd(), shape, n_workers=2, device="cpu", model=2,
                         microbatch=2 if comm.overlap == "pipelined" else 1, cache=False)
    # the booked collectives of a forward at M = 1 are none
    with comms.capture() as log:
        ids = torch.zeros((2, 8), dtype=torch.long)
        T.forward_loss(cfg, T.init_params(cfg, 0, "cpu"), {"tokens": ids, "labels": ids})
    assert not log.records
