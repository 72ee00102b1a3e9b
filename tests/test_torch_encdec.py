"""The audio encoder-decoder (seamless-m4t-large-v2: frame embeddings through
a non-causal encoder, cross-attention in every decoder block) in the port
against the JAX package.

* ``sdpa_chunked`` not causal, over keys of another length than the
  queries (the encoder's self-attention, windowed or not, and
  cross-attention), at the port's query chunks (ragged too) against the
  reference's ``causal=False``: rtol 1e-5; ``attention`` with a
  ``kv_source`` (no rotation, K/V from the memory), MHA and GQA, against
  the reference's under ``shard_map``: rtol 1e-5 / atol 1e-5 x max.
* ``_encode`` (frames @ ``frontend_proj``, the dense encoder blocks,
  ``enc_ln_f``) in both layouts against the reference's: rtol 1e-5.
* ``forward_loss`` and every leaf's gradient (the encoder's and the
  cross-attention's among them), f32, both layouts: loss rtol 1e-5,
  gradients rtol 1e-4 / atol 1e-6.
* Prefill (``enc_out`` kept in the cache) and 6 greedy decode steps through
  both packages' ``build_serve``, both layouts (caches rtol 1e-5 / atol
  1e-5 x max, tokens equal); the port's decode-equivalence identity within
  1e-4 of max|logits|; ``serve_step`` equal to ``decode_step`` bitwise, and
  ``enc_out`` left as it was.
* The W = 4 trainer: 3 steps of ``signsgd_packed`` EF on the packed wire
  against the reference's ``build_bundle`` (one subprocess): losses rtol
  1e-4, booked wire by tag and axes equal.
* A checkpoint of an encoder-decoder state: a port round trip bitwise,
  the file restored by the reference into its own state (every leaf
  equal) and its next step's loss within rtol 1e-4 of the port's.
* The full-width tree from the defs; the refusals that still hold;
  ``launch/train.py`` and ``launch/serve.py --reduced --device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint import restore as jrestore
from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.core.types import CommConfig as JCommConfig
from repro.data.pipeline import SyntheticBatches as JSyntheticBatches
from repro.launch.mesh import make_test_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import check_ported
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_ckpt import _assert_states_equal, _flat, _jflat, deterministic  # noqa: F401
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)
from test_torch_vlm import (B, S, full_width_tree_matches_reference, grads_match_reference,
                            reference_params, serve_matches_reference,
                            serve_step_is_decode_step, series_matches_reference,
                            start_reference_series, stop)

ARCH = "seamless-m4t-large-v2"


def _run_jax(fn, *args):
    """``fn`` under ``shard_map`` on a 1 x 1 mesh, everything replicated."""
    specs = jax.tree.map(lambda _: P(), args)
    return np.asarray(jax.jit(shard_map(fn, mesh=make_test_mesh(1, 1), in_specs=specs,
                                        out_specs=P(), check_vma=False))(*args))


def _close(got, want, what="", rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


# ---------------------------------------------------------------------------
# Attention that is not causal.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Sk,window,q_chunk", [
    (12, 20, 12, 1024),  # cross-attention at training: window = the decoder's length
    (12, 20, 12, 5),  # the same in ragged query chunks
    (1, 9, 9, 1024),  # cross-attention at decode: window = the encoder's length
    (20, 20, 20, 8),  # the encoder's self-attention
    (20, 20, 4, 8),  # a windowed non-causal mask (q - k < 4, one-sided)
    (16, 7, 16, 4),  # fewer keys than queries
])
def test_sdpa_not_causal_matches_reference(Sq, Sk, window, q_chunk):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 8)).astype(np.float32) for _ in range(2))
    got = L.sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                         causal=False, q_chunk=q_chunk)
    want = np.asarray(JL.sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                      q_pos=jnp.arange(Sq), k_pos=jnp.arange(Sk), window=window,
                                      causal=False, q_chunk=1024))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    causal = L.sdpa_chunked(*(torch.from_numpy(a) for a in (q[:, :min(Sq, Sk)], k, v)),
                            window=window, q_chunk=q_chunk)
    assert not np.allclose(causal.numpy(), want[:, :min(Sq, Sk)], rtol=1e-3)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_cross_attention_matches_reference(n_kv):
    """Queries from x (B, 12, d), K and V from the memory (B, 20, d), no
    rotation: MHA (seamless's) and GQA (2 KV heads for 4)."""
    jcfg = jget(ARCH).reduced().with_updates(n_kv_heads=n_kv)
    cfg = get_config(ARCH).reduced().with_updates(n_kv_heads=n_kv)
    jp = JT.init_params(jcfg, jax.random.key(1), 1)["blocks"][0]["0"]["xattn"]
    rng = np.random.default_rng(n_kv)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want = _run_jax(lambda p, h, m: JL.attention(
        jcfg, p, h, AxisCtx(), positions=JT.make_positions(jcfg, 2, 12), window=12,
        causal=False, kv_source=m), jp, jnp.asarray(x), jnp.asarray(mem))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    got = L.attention(cfg, p, torch.from_numpy(x), positions=None, window=12, causal=False,
                      kv_source=torch.from_numpy(mem))
    _close(got, want)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_encode_matches_reference(scan_layers):
    jcfg, jparams, cfg, params = reference_params(ARCH, scan_layers)
    frames = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _, specs, _ = JT.abstract_params(jcfg, 1)
    fn = jax.jit(shard_map(lambda p, f: JT._encode(jcfg, p, {"frames": f}, AxisCtx()),
                           mesh=make_test_mesh(1, 1), in_specs=(specs, P()), out_specs=P(),
                           check_vma=False))
    want = np.asarray(fn(jparams, jnp.asarray(frames)))
    got = T._encode(cfg, params, {"frames": torch.from_numpy(frames)})
    assert got.shape == (2, 16, cfg.d_model)
    _close(got, want, "enc_out")


# ---------------------------------------------------------------------------
# Training and serving against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_loss_and_grads_match_reference(scan_layers):
    grads_match_reference(ARCH, scan_layers)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_match_reference(scan_layers):
    serve_matches_reference(ARCH, scan_layers)


def test_decode_matches_full_forward():
    cfg = get_config(ARCH).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    full = SyntheticBatches(cfg, InputShape("p", S + 1, B, "prefill"), seed=1).batch(0)
    full = {k: torch.from_numpy(v) for k, v in full.items()}
    assert full["frames"].shape == (B, 6, cfg.d_model)
    with torch.no_grad():
        _, cache = T.prefill(cfg, params, {"frames": full["frames"],
                                           "tokens": full["tokens"][:, :S]}, max_seq=S + 1)
        assert cache["enc_out"].shape == (B, 6, cfg.d_model)
        got, _ = T.decode_logits(cfg, params, cache, full["tokens"][:, S:], max_seq=S + 1)
        h, _ = T.forward_hidden(cfg, params, full)
        want = L.logits_local(params["embed"], h[:, -1:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_serve_step_is_decode_step(scan_layers):
    serve_step_is_decode_step(ARCH, scan_layers)


# ---------------------------------------------------------------------------
# The W = 4 trainer against the reference's bundle; checkpoints.
# ---------------------------------------------------------------------------

SIGN_EF = dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True)


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    proc = start_reference_series(ARCH, SIGN_EF)
    yield proc
    stop(proc)


def test_trainer_series_matches_reference(_reference_run):
    series_matches_reference(_reference_run, ARCH, SIGN_EF)


def test_checkpoint_crosses_the_packages(tmp_path, deterministic):  # noqa: F811
    """qsgd_kernel EF with momentum 0.9 at W = 1 for 2 steps: the port's
    round trip is bitwise (the encoder's leaves, the cross-attention's, the
    frontend's and their EF residuals and momenta among them) and the next
    step from it equals the uninterrupted one; the reference restores the
    file into its own state, every leaf equal, and its next step's loss is
    the port's within rtol 1e-4."""
    comm = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                wire_format="compressed", error_feedback=True, bucket_mb=1.0)
    cfg = get_config(ARCH).reduced()
    shape = InputShape("train", 16, 4, "train")
    bundle = build_bundle(cfg, CommConfig(**comm), opt.momentum_sgd(0.9), shape, n_workers=1,
                          seed=0, device="cpu")
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(0.01), log_every=1)
    state = tr.fit(bundle.init_state(reference_params(ARCH, False)[3]), 2)
    tr.save(str(tmp_path / "ck"), state, 2)
    back, step = tr.restore(str(tmp_path / "ck"))
    assert step == 2
    _assert_states_equal(back, state)
    # copies: the next steps update the state's tensors in place
    port_flat = {k: np.array(v) for k, v in _flat(bundle.checkpoint_tree(state)).items()}
    assert {k.split("/")[1] for k in port_flat if k.startswith("params/")} >= {
        "encoder", "enc_ln_f", "frontend_proj"}
    assert any("/xattn/" in k for k in port_flat if k.startswith("opt/"))
    n = len(tr.history)
    state = tr.fit(state, 1, start_step=2)
    back = tr.fit(back, 1, start_step=2)
    assert tr.history[n]["loss"] == tr.history[n + 1]["loss"]
    _assert_states_equal(back, state)

    jcfg = jget(ARCH).reduced()
    jb = jbuild_bundle(jcfg, make_test_mesh(data=1, model=1), JCommConfig(**comm),
                       jopt.momentum_sgd(0.9), shape, seed=0, cache=False)
    jt = JTrainer(jb, JSyntheticBatches(jcfg, shape, seed=0), jconstant(0.01), log_every=1)
    jstate, step = jrestore(str(tmp_path / "ck"), jt.init())
    assert step == 2
    ref_flat = _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)
    jt.fit(jstate, 1, start_step=2)
    assert jt.history[-1]["loss"] == pytest.approx(tr.history[n]["loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# The full-width tree, the refusals, the launchers.
# ---------------------------------------------------------------------------


def test_full_width_param_tree_matches_reference():
    got = full_width_tree_matches_reference(ARCH)
    # the vocabulary padded to a multiple of 128: 256,206 -> 256,256 rows
    assert got["embed/embedding"] == (256256, 1024) and got["frontend_proj"] == (1024, 1024)
    assert got["encoder/attn/wq"] == (24, 1024, 16, 64) and got["enc_ln_f"] == (1024,)
    assert got["blocks/0/xattn/wk"] == (24, 1024, 16, 64) and "bq" not in str(got)
    count = sum(int(np.prod(s)) for s in got.values())
    assert 1.75e9 < count < 1.8e9


@pytest.mark.parametrize("upd", [
    dict(kv_lora=512),  # an MLA encoder-decoder
    dict(family="hybrid"),  # Mamba heads beside the cross-attention
    dict(modality="text"),  # no frames to encode
    dict(family="moe", moe=True, n_experts=4, experts_per_token=2),  # not a dense family
])
def test_unported_encoder_decoder_options_are_refused(upd):
    with pytest.raises(NotImplementedError):
        check_ported(get_config(ARCH).with_updates(**upd))


def test_train_launcher_runs_seamless(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                              "--workers", "2", "--seq-len", "16", "--global-batch", "4",
                              "--warmup", "1", "--comm", "qsgd"]) == 0
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_launcher_runs_seamless(capsys):
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
                              "20", "--batch", "2", "--decode", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 20x2: ")
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)
