"""The port's serving of the attention families against the JAX package:
the ring KV cache, windowed decode attention, MLA's latent decode and the
MoE decode, through both packages' ``build_serve``.

* Prefill and greedy decode of each family's ``reduced()`` config (f32),
  the reference's weights carried across with ``repro_torch.interop``:
  the last hidden state and every cache leaf (paths, shapes, ``pos``
  exact) of the port's ``build_serve`` prefill against the reference's on
  a 1 x 1 mesh, then 6 greedy steps each from the reference's own cache.
  The prefill passes no ``max_seq``, so the rings hold the prompt (gemma3's
  local rings its window of 16): the steps evict the oldest positions.
  Greedy tokens equal at every step, the caches close at the end.  This
  module runs the dense families (qwen3-0.6b and gemma3-12b in both
  ``scan_layers`` layouts); ``test_torch_serve_mla.py`` the MoE and MLA
  ones.
* The decode-equivalence identity of ``tests/test_decode_equivalence.py``
  in the port alone, for all six families: ``prefill(max_seq=S+1)`` plus
  one ``decode_logits`` against the full forward's last-position logits
  over the S+1 tokens (the MoE at cf = E: no token dropped).
* ``decode_step`` leaves its input cache alone; ``serve_step`` (in place)
  equals it bitwise; ``check_serving`` refuses ``seq_par``, VL and the
  encoder-decoder, each naming its slice; the launcher runs.

Tolerances (f32 on the CPU; the frameworks sum products in other orders):
last hidden state and caches rtol 1e-5 with an atol of 1e-5 times the
tensor's largest magnitude; the identity's logits within 1e-4 of max|logits|
(the card's criterion, phase S of ``chip_smoke.py``), tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import InputShape as JInputShape
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.train.steps import build_serve as jbuild_serve
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths, tree_map
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

RTOL = 1e-5
#: prompt, batch and greedy steps of the parity runs
S, B, STEPS = 24, 2, 6
FAMILIES = ("qwen3-0.6b", "glm4-9b", "qwen1.5-32b", "gemma3-12b", "qwen3-moe-30b-a3b",
            "deepseek-v2-lite-16b")


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=what)


def serve_matches_reference(arch: str, scan_layers: bool) -> None:
    """Prefill, then STEPS greedy steps from the reference's own cache,
    through both packages' ``build_serve``."""
    jcfg = jget(arch).reduced().with_updates(scan_layers=scan_layers)
    cfg = get_config(arch).reduced().with_updates(scan_layers=scan_layers)
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
    params = interop.params_from_numpy(_flat_np(jparams), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jsb = jbuild_serve(jcfg, make_test_mesh(1, 1), JInputShape("t", S + STEPS, B, "decode"))
    jlast, jcache = jsb.prefill_step(jparams, {"tokens": jnp.asarray(toks)})
    jcache_np = _flat_np(jcache)

    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    last, cache = sb.prefill_step(params, {"tokens": toks})
    _close(last, np.asarray(jlast), "last hidden")
    got = flatten_with_paths(cache)
    assert list(got) == list(jcache_np)
    for path, t in got.items():
        want = jcache_np[path]
        assert tuple(t.shape) == want.shape, path
        if path.endswith("pos"):
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
        else:
            _close(t, want, path)
    assert int(cache["pos"]) == S

    cache = interop.cache_from_numpy(jcache_np, cache)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    jtok = jnp.zeros((B, 1), jnp.int32)
    for t in range(STEPS):
        tok, cache = sb.serve_step(params, cache, tok)
        jtok, jcache = jsb.serve_step(jparams, jcache, jtok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {t}")
    got = flatten_with_paths(cache)
    for path, want in _flat_np(jcache).items():
        if path.endswith("pos"):
            np.testing.assert_array_equal(got[path].numpy(), want, err_msg=path)
        else:
            _close(got[path], want, path)
    assert int(cache["pos"]) == S + STEPS


@pytest.mark.parametrize("arch,scan_layers", [("qwen3-0.6b", False), ("qwen3-0.6b", True),
                                              ("glm4-9b", False), ("qwen1.5-32b", False),
                                              ("gemma3-12b", False), ("gemma3-12b", True)])
def test_prefill_and_decode_match_reference(arch, scan_layers):
    serve_matches_reference(arch, scan_layers)


def test_rings_are_prompt_sized_and_wrap():
    """gemma3's reduced local layers ring 16 of the 24 prompt positions; the
    global ring holds all 24, and the first decoded token (position 24)
    evicts position 0 from it (the reference's steady-state ring)."""
    cfg = get_config("gemma3-12b").reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((B, S), dtype=torch.int32)
    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    _, cache = sb.prefill_step(params, {"tokens": toks})
    local, glob = (cache["blocks"][0][str(i)]["attn"]["pos"] for i in (0, 1))
    assert local.tolist() == [16 + s if s < S - 16 else s for s in range(16)]
    assert glob.tolist() == list(range(S))
    _, cache = sb.serve_step(params, cache, toks[:, :1])
    glob = cache["blocks"][0]["1"]["attn"]["pos"]
    assert glob.tolist() == [S] + list(range(1, S))


# ---------------------------------------------------------------------------
# The decode-equivalence identity, in the port alone.
# ---------------------------------------------------------------------------


def _identity_cfg(arch: str) -> ModelConfig:
    cfg = get_config(arch).reduced()
    # cf = E: no token is capacity-dropped, which otherwise differs between
    # T = B decode tokens and the full forward's T = B * (S + 1)
    return cfg.with_updates(moe_capacity_factor=float(cfg.n_experts)) if cfg.moe else cfg


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    cfg = _identity_cfg(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    with torch.no_grad():
        # capacity S + 1: decoding position S must not evict position 0
        _, cache = T.prefill(cfg, params, {"tokens": toks[:, :S]}, max_seq=S + 1)
        got, _ = T.decode_logits(cfg, params, cache, toks[:, S:], max_seq=S + 1)
        h, _ = T.forward_hidden(cfg, params, toks)
        want = L.logits_local(params["embed"], h[:, -1:], softcap=cfg.logits_softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


# ---------------------------------------------------------------------------
# The step contracts, the refusals, the launcher.
# ---------------------------------------------------------------------------


def _prefilled(arch: str, scan_layers: bool = False):
    cfg = get_config(arch).reduced().with_updates(scan_layers=scan_layers)
    params = T.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
                            .astype(np.int32))
    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    _, cache = sb.prefill_step(params, {"tokens": toks})
    return cfg, params, sb, cache, toks[:, :1]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_decode_leaves_its_input_cache_alone(arch):
    cfg, params, _, cache, tok = _prefilled(arch)
    before = {k: v.clone() for k, v in flatten_with_paths(cache).items()}
    T.decode_step(cfg, params, cache, tok, max_seq=S + STEPS)
    for k, v in flatten_with_paths(cache).items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch,scan_layers", [("qwen3-0.6b", True), ("gemma3-12b", False),
                                              ("deepseek-v2-lite-16b", True)])
def test_serve_step_is_decode_step(arch, scan_layers):
    """``serve_step`` writes the ring slots into the cache it is given; over
    STEPS steps its tokens and caches equal ``decode_step``'s bitwise."""
    cfg, params, sb, cache, tok = _prefilled(arch, scan_layers)
    want_tok, want = tok, cache
    cache = tree_map(torch.clone, cache)
    for t in range(STEPS):
        tok, cache = sb.serve_step(params, cache, tok)
        with torch.no_grad():
            want_tok, want = T.decode_step(cfg, params, want, want_tok, max_seq=S + STEPS)
        assert torch.equal(tok, want_tok), t
        for (k, v), w in zip(flatten_with_paths(cache).items(), flatten_with_paths(want).values()):
            assert torch.equal(v, w), (t, k)


def test_seq_par_serving_is_refused():
    for arch in ("qwen3-0.6b", "rwkv6-3b"):
        cfg = get_config(arch).reduced().with_updates(seq_par=True)
        with pytest.raises(NotImplementedError, match="seq_par prefill .* later slice"):
            build_serve(cfg, InputShape("t", 8, 2, "decode"), "cpu")
    cfg = get_config("qwen3-0.6b").reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        T.prefill(cfg.with_updates(seq_par=True), params,
                  {"tokens": torch.zeros((2, 8), dtype=torch.int32)})


@pytest.mark.parametrize("arch,slice_", [("qwen2-vl-2b", "qwen2-vl"),
                                         ("seamless-m4t-large-v2", "encoder-decoder")])
def test_unported_serving_is_refused(arch, slice_):
    cfg = ModelConfig(**dataclasses.asdict(jget(arch)))
    with pytest.raises(NotImplementedError, match=f"{slice_}.*later slice"):
        T.check_serving(cfg)


def test_decode_needs_max_seq():
    cfg, params, _, cache, tok = _prefilled("qwen3-0.6b")
    with pytest.raises(ValueError, match="max_seq"):
        T.decode_step(cfg, params, cache, tok)


def test_serve_launcher_runs_dense(capsys):
    assert launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                              "--prompt-len", "16", "--batch", "2", "--decode", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 16x2: ") and lines[0].endswith(" ms")
    assert lines[1].startswith("decoded 5 tokens/seq in ") and "tok/s total" in lines[1]
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


@pytest.mark.parametrize("window", [25, 16])
def test_sdpa_takes_a_ragged_last_chunk(window):
    """The port's query chunks need not divide the sequence (the reference
    asserts they do): 25 queries in chunks of 8 (the last one 1) against the
    reference's single chunk, the window sliced per chunk."""
    from repro.models import layers as JL

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 25, n, 8)).astype(np.float32) for n in (4, 2, 2))
    got = L.sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)), window=window, q_chunk=8)
    want = JL.sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.arange(25),
                           k_pos=jnp.arange(25), window=window, causal=True, q_chunk=1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
