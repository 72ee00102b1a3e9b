"""The port's model, data, optimizer and schedule layers against the JAX
package on the tiny workload (qwen3-0.6b reduced: d_model 128, 4/2 heads,
head_dim 32, d_ff 256, vocab 128, f32), with the reference's initial
parameters carried across through repro_torch.interop.

Tolerances: loss rtol 1e-5 and every gradient leaf rtol 1e-4 / atol 1e-6
(f32 on the CPU; the two frameworks sum matrix products in different
orders).  Data and schedules are numpy/f32 copies and must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs.base import InputShape as JInputShape
from repro.data.pipeline import BigramSource as JBigram
from repro.data.pipeline import SyntheticBatches as JSynthetic
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.pipeline import BigramSource, SyntheticBatches
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)


def _tiny_cfg(**upd):
    return get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, **upd)


def test_tiny_config_matches_reference():
    jcfg, jshape, _ = make_tiny_workload()
    cfg = _tiny_cfg()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
              "qk_norm", "rope_theta", "param_dtype", "compute_dtype", "scan_layers", "remat",
              "window", "attn_pattern"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (jshape.seq_len, jshape.global_batch) == (64, 16)


def _jax_loss_and_grads(jcfg, jparams, batch):
    mesh = make_test_mesh(1, 1)
    ax = AxisCtx()
    _, specs, _ = JT.abstract_params(jcfg, 1)

    def f(p, b):
        (loss, m), g = jax.value_and_grad(
            lambda q: JT.forward_loss(jcfg, q, b, ax), has_aux=True)(p)
        return loss, g

    bspec = {"tokens": P("data", None), "labels": P("data", None)}
    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(specs, bspec), out_specs=(P(), specs),
                           check_vma=False))
    loss, grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in jflatten(grads).items()}


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_loss_and_grads_match_reference(scan_layers):
    jcfg, jshape, jdata = make_tiny_workload()
    jcfg = jcfg.with_updates(scan_layers=scan_layers)
    cfg = _tiny_cfg(scan_layers=scan_layers)
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    params = interop.params_from_numpy(flat, cfg, "cpu")
    # the tree round-trips through numpy unchanged
    back = interop.params_to_numpy(params)
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    batch = jdata.batch(0)
    want_loss, want_grads = _jax_loss_and_grads(jcfg, jparams, batch)

    tparams = {k: v for k, v in flatten_with_paths(params).items()}
    for v in tparams.values():
        v.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = T.forward_loss(cfg, params, tb)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"].detach()), want_loss, rtol=1e-5)
    assert float(m["aux"]) == 0.0
    assert list(tparams) == list(want_grads)
    for (path, g) in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_full_width_param_tree_matches_reference():
    """qwen3-0.6b at published width: same 13 leaves, paths and shapes
    (from the defs alone, nothing allocated)."""
    from repro.configs import get_config as jget

    jabs, _, _ = JT.abstract_params(jget("qwen3-0.6b"), 1)
    want = {k: tuple(v.shape) for k, v in jflatten(jabs).items()}
    got = {k: tuple(d.shape) for k, d in flatten_with_paths(T.param_defs(get_config("qwen3-0.6b"))).items()}
    assert list(got) == list(want)
    assert got == want
    assert len(got) == 13 and sum(int(np.prod(s)) for s in got.values()) == 596_049_920


@pytest.mark.parametrize("q_chunk", [64, 16, 8])
def test_sliding_window_matches_reference(q_chunk, monkeypatch):
    """A ``local`` layer, window 16 at seq 64, against the reference's
    ``attention`` at the same query chunk: 64 reads the whole KV block,
    16 and 8 slice it to window + chunk keys; rtol 1e-5."""
    import functools

    from repro.models import layers as JL

    jcfg = make_tiny_workload()[0].with_updates(attn_pattern=("local",))
    cfg = _tiny_cfg(attn_pattern=("local",))
    assert cfg.layer_window("local", 64) == 16
    jp = JT.init_params(jcfg, jax.random.key(0), 1)["blocks"][0]["0"]["attn"]
    x = np.random.default_rng(3).standard_normal((2, 64, 128)).astype(np.float32)
    monkeypatch.setattr(JL, "sdpa_chunked", functools.partial(JL.sdpa_chunked, q_chunk=q_chunk))
    specs = jax.tree.map(lambda _: P(), jp)
    fn = jax.jit(shard_map(
        lambda p, h: JL.attention(jcfg, p, h, AxisCtx(), positions=JT.make_positions(jcfg, 2, 64),
                                  window=16),
        mesh=make_test_mesh(1, 1), in_specs=(specs, P()), out_specs=P(), check_vma=False))
    want = np.asarray(fn(jp, jnp.asarray(x)))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    pos = T.make_positions(cfg, 2, 64, "cpu")
    got = L.attention(cfg, p, torch.from_numpy(x), positions=pos, window=16, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    full = L.attention(cfg, p, torch.from_numpy(x), positions=pos, window=64, q_chunk=q_chunk)
    assert not np.allclose(full.numpy(), want, rtol=1e-3)  # the window bites


def test_init_params_shapes_and_dtype():
    cfg = _tiny_cfg()
    params = T.init_params(cfg, seed=3, device="cpu")
    flat = flatten_with_paths(params)
    defs = flatten_with_paths(T.param_defs(cfg))
    assert {k: tuple(v.shape) for k, v in flat.items()} == {k: d.shape for k, d in defs.items()}
    assert all(v.dtype == torch.float32 for v in flat.values())
    assert torch.equal(flat["ln_f"], torch.ones(128))
    again = flatten_with_paths(T.init_params(cfg, seed=3, device="cpu"))
    assert all(torch.equal(flat[k], again[k]) for k in flat)


@pytest.mark.parametrize("step", [0, 5])
def test_bigram_source_matches_reference(step):
    want = JBigram(128, seed=0).batch(step, 16, 64)
    got = BigramSource(128, seed=0).batch(step, 16, 64)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_batches_match_reference():
    from repro.configs import get_config as jget

    want = JSynthetic(jget("qwen3-0.6b"), JInputShape("t", 32, 4, "train"), seed=2).batch(3)
    got = SyntheticBatches(get_config("qwen3-0.6b"), InputShape("t", 32, 4, "train"),
                           seed=2).batch(3)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name,args", [("sgd", ()), ("momentum_sgd", (0.9,)),
                                       ("momentum_sgd", (0.0,))])
def test_optimizer_update_matches_reference(name, args):
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
          for _ in range(2)]
    jo, to = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, None
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = to.init(tp)
    tl = [tp["a"], tp["b"]]
    for g in gs:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 0.05)
        tl, ts = to.update([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])], ts, tl, 0.05)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jp["b"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", [0, 3, 10, 50, 120])
def test_schedules_match_reference(step):
    assert tsched.constant(0.05)(step) == float(jsched.constant(0.05)(step))
    np.testing.assert_allclose(tsched.warmup_cosine(0.1, 10, 100)(step),
                               float(jsched.warmup_cosine(0.1, 10, 100)(step)), rtol=1e-6)
