"""The vision family (qwen2-vl-2b: M-RoPE, patch embeddings before the text)
in the port against the JAX package, and what both new families share.

* ``make_positions`` (the M-RoPE grid of the patches, then the text) exact
  against the reference's, for the vision and the audio config at several
  lengths; ``apply_rope``'s M-RoPE branch at the published sections (16,
  24, 24) and the reduced ones, at grid and random positions: rtol 1e-6 /
  atol 1e-6 x max.
* ``SyntheticBatches`` bitwise equal to the reference's for both families
  (the patches or frames drawn first, then the text tokens), train and
  prefill batches.
* ``forward_loss`` and every leaf's gradient of the reduced qwen2-vl (f32,
  list and stacked layouts, the stacked one on the list's weights), only
  the text positions labelled, against the reference's ``value_and_grad``
  on a 1 x 1 mesh: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6.
* Prefill and 6 greedy decode steps through both packages' ``build_serve``
  (the prompt's patches and tokens), in both layouts: the last hidden
  state and every cache leaf rtol 1e-5 / atol 1e-5 x max, ``pos`` exact,
  then the steps from the reference's own cache, tokens equal.
* The decode-equivalence identity in the port alone: the decode's M-RoPE
  streams are all the position S (the reference's), while the full forward
  gives a text token index S - n_vis + side, so the full forward is built
  from the port's internals with the last index's streams set to S (the
  prompt S = 24 keeps int(S / 4) = int((S + 1) / 4)): logits within 1e-4 of
  max|logits|; ``serve_step`` equal to ``decode_step`` bitwise.
* The W = 4 trainer: 3 steps of ``qsgd_kernel`` EF against the reference's
  ``build_bundle`` on a ``data=4`` mesh in one subprocess, the noise hook
  replaying its key chain: losses rtol 1e-4, booked wire by tag and axes
  equal.  The worker and microbatch splits slice every key of the batch.
* The full-width tree from the defs; the refusals that still hold;
  ``launch/train.py`` and ``launch/serve.py --reduced --device cpu``.
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
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.configs.base import InputShape as JInputShape
from repro.data.pipeline import SyntheticBatches as JSyntheticBatches
from repro.launch.mesh import make_test_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.train.steps import build_serve as jbuild_serve
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
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
from repro_torch.train.steps import build_bundle, build_serve
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import flatten_with_paths, tree_map
from test_torch_moe import _by_tag_axes
from test_torch_sync import _noise, _one_thread  # noqa: F401  (torch on one thread)

ARCH = "qwen2-vl-2b"
NEW = ("qwen2-vl-2b", "seamless-m4t-large-v2")
#: prompt (patches included), batch and greedy steps of the serving runs
S, B, STEPS = 24, 2, 6


def _np(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


def _close(got: torch.Tensor, want, what: str, rtol: float = 1e-5) -> None:
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


def reference_params(arch: str, scan_layers: bool):
    """(reference cfg, its reduced params, port cfg, the same params in the
    port).  The stacked layout takes the list layout's weights, stacked
    (drawn stacked, a leaf would get std 1/sqrt(repeats): the reference's
    fan-in rule)."""
    jcfg = jget(arch).reduced().with_updates(scan_layers=scan_layers)
    cfg = get_config(arch).reduced().with_updates(scan_layers=scan_layers)
    jparams = JT.init_params(jcfg.with_updates(scan_layers=False), jax.random.key(0), 1)
    if scan_layers:
        for k in ("blocks", "encoder"):
            if k in jparams:
                jparams = {**jparams, k: jax.tree.map(lambda *xs: jnp.stack(xs), *jparams[k])}
    return jcfg, jparams, cfg, interop.params_from_numpy(_np(jparams), cfg, "cpu")


def reference_loss_and_grads(jcfg, jparams, batch: dict):
    """The reference's loss, metrics and gradients on a 1 x 1 mesh, for a
    batch with any of ``patches``, ``frames``, ``tokens``, ``labels``."""
    _, specs, _ = JT.abstract_params(jcfg, 1)

    def f(p, b):
        (loss, m), g = jax.value_and_grad(
            lambda q: JT.forward_loss(jcfg, q, b, AxisCtx()), has_aux=True)(p)
        return loss, m, g

    bspec = {k: P("data", *([None] * (v.ndim - 1))) for k, v in batch.items()}
    fn = jax.jit(shard_map(f, mesh=make_test_mesh(1, 1), in_specs=(specs, bspec),
                           out_specs=(P(), P(), specs), check_vma=False))
    loss, m, g = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in m.items()}, _np(g)


def grads_match_reference(arch: str, scan_layers: bool, seq: int = 64) -> None:
    jcfg, jparams, cfg, params = reference_params(arch, scan_layers)
    batch = SyntheticBatches(cfg, InputShape("t", seq, 2, "train"), seed=3).batch(0)
    want_loss, want_m, want_grads = reference_loss_and_grads(jcfg, jparams, batch)
    tparams = flatten_with_paths(params)
    for v in tparams.values():
        v.requires_grad_(True)
    loss, m = T.forward_loss(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"].detach()), want_m["ce"], rtol=1e-5)
    assert list(tparams) == list(want_grads)
    for path, g in zip(tparams, grads):
        assert bool(torch.count_nonzero(g)) or not np.any(want_grads[path]), path
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def prompt(cfg, seed: int = 1) -> dict[str, np.ndarray]:
    """A prefill batch of S positions (patches or frames, then tokens)."""
    return SyntheticBatches(cfg, InputShape("p", S, B, "prefill"), seed=seed).batch(0)


def serve_matches_reference(arch: str, scan_layers: bool) -> None:
    """Prefill, then STEPS greedy steps from the reference's own cache,
    through both packages' ``build_serve``."""
    jcfg, jparams, cfg, params = reference_params(arch, scan_layers)
    batch = prompt(cfg)
    jsb = jbuild_serve(jcfg, make_test_mesh(1, 1), JInputShape("t", S + STEPS, B, "decode"))
    jlast, jcache = jsb.prefill_step(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jcache_np = _np(jcache)
    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    last, cache = sb.prefill_step(params, batch)
    _close(last, jlast, "last hidden")
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
    tok, jtok = torch.zeros((B, 1), dtype=torch.int32), jnp.zeros((B, 1), jnp.int32)
    for t in range(STEPS):
        tok, cache = sb.serve_step(params, cache, tok)
        jtok, jcache = jsb.serve_step(jparams, jcache, jtok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {t}")
    got = flatten_with_paths(cache)
    for path, want in _np(jcache).items():
        if path.endswith("pos"):
            np.testing.assert_array_equal(got[path].numpy(), want, err_msg=path)
        else:
            _close(got[path], want, path)
    assert int(cache["pos"]) == S + STEPS


def serve_step_is_decode_step(arch: str, scan_layers: bool) -> None:
    """``serve_step`` writes the ring slots into the cache it is given (and
    never ``enc_out``); over STEPS steps its tokens and caches equal
    ``decode_step``'s bitwise, which leaves its input cache alone."""
    cfg = get_config(arch).reduced().with_updates(scan_layers=scan_layers)
    params = T.init_params(cfg, seed=2, device="cpu")
    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    batch = prompt(cfg, seed=2)
    _, cache = sb.prefill_step(params, batch)
    want, want_tok = cache, torch.from_numpy(batch["tokens"][:, :1])
    tok = want_tok
    cache = tree_map(torch.clone, cache)
    for t in range(STEPS):
        before = {k: v.clone() for k, v in flatten_with_paths(want).items()}
        with torch.no_grad():
            want_tok, new = T.decode_step(cfg, params, want, want_tok, max_seq=S + STEPS)
        for k, v in flatten_with_paths(want).items():
            assert torch.equal(v, before[k]), (t, k)
        want = new
        enc = cache.get("enc_out")
        tok, cache = sb.serve_step(params, cache, tok)
        assert enc is None or cache["enc_out"] is enc
        assert torch.equal(tok, want_tok), t
        for (k, v), w in zip(flatten_with_paths(cache).items(),
                             flatten_with_paths(want).values()):
            assert torch.equal(v, w), (t, k)


def full_width_tree_matches_reference(arch: str) -> dict:
    jabs, _, _ = JT.abstract_params(jget(arch), 1)
    want = {k: tuple(v.shape) for k, v in jflatten(jabs).items()}
    got = {k: tuple(d.shape) for k, d in flatten_with_paths(T.param_defs(get_config(arch))).items()}
    assert list(got) == list(want)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Positions, M-RoPE, batches.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("S_", [1, 5, 24, 37, 64])
def test_make_positions_matches_reference(arch, S_):
    want = np.asarray(JT.make_positions(jget(arch), 3, S_))
    got = T.make_positions(get_config(arch), 3, S_, "cpu")
    assert got.shape == (3, 3, S_)
    np.testing.assert_array_equal(got.numpy(), want)


def test_positions_lay_the_patches_on_a_grid():
    """At S = 1024 (the card's prompt): 256 patches on a 16 x 16 grid, then
    text token i at i - 256 + 16 in all three streams."""
    pos = T.make_positions(get_config(ARCH), 1, 1024, "cpu")[:, 0]
    assert pos[:, 255].tolist() == [0, 15, 15] and pos[:, 17].tolist() == [0, 1, 1]
    assert pos[:, 256].tolist() == [16, 16, 16] and pos[:, 1023].tolist() == [783] * 3


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("grid", [True, False])
def test_mrope_matches_reference(reduced, grid):
    """Each section (t, h, w) rotated by its own stream, its inverse
    frequencies restarting at index 0: the reference's layout."""
    cfg = get_config(ARCH).reduced() if reduced else get_config(ARCH)
    jcfg = jget(ARCH).reduced() if reduced else jget(ARCH)
    cfg = cfg.with_updates(compute_dtype="float32", param_dtype="float32")
    hd = cfg.resolved_head_dim
    assert sum(cfg.mrope_sections) == hd // 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    if grid:
        pos = np.array(JT.make_positions(jcfg, 2, 40))
    else:
        pos = rng.integers(0, 4096, (3, 2, 40)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)))
    got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the three streams differ in what they rotate: not the plain RoPE
    plain = L.apply_rope(cfg.with_updates(rope_type="rope"), torch.from_numpy(x),
                         torch.from_numpy(pos))
    assert not torch.allclose(plain, got, atol=1e-3)


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_synthetic_batches_match_reference(arch, kind):
    got = SyntheticBatches(get_config(arch), InputShape("t", 37, 3, kind), seed=5).batch(4)
    want = JSyntheticBatches(jget(arch), JInputShape("t", 37, 3, kind), seed=5).batch(4)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    extra = "patches" if arch == ARCH else "frames"
    assert got[extra].shape == ((3, 9, 1536) if arch == ARCH else (3, 9, 1024))
    assert got["tokens"].shape == ((3, 28) if arch == ARCH else (3, 37))


# ---------------------------------------------------------------------------
# Training and serving against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_loss_and_grads_match_reference(scan_layers):
    grads_match_reference(ARCH, scan_layers)


def test_only_text_positions_carry_labels():
    """The loss reads the last S_text positions: changing a patch moves the
    loss (through attention) but the patches' own outputs are unlabelled,
    so the labels are (B, S_text)."""
    cfg = get_config(ARCH).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticBatches(cfg, InputShape("t", 32, 2, "train")).batch(0).items()}
    assert batch["labels"].shape == (2, 24) and batch["patches"].shape == (2, 8, 256)
    h, _ = T.forward_hidden(cfg, params, batch)
    assert h.shape == (2, 32, 256)
    want = L.logits_and_loss(params["embed"], h[:, 8:], batch["labels"])
    assert torch.equal(T.forward_loss(cfg, params, batch)[1]["ce"], want)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_match_reference(scan_layers):
    serve_matches_reference(ARCH, scan_layers)


def test_decode_matches_full_forward():
    cfg = get_config(ARCH).reduced()
    assert int(S * cfg.vision_fraction) == int((S + 1) * cfg.vision_fraction) == 6
    params = T.init_params(cfg, seed=0, device="cpu")
    full = SyntheticBatches(cfg, InputShape("p", S + 1, B, "prefill"), seed=1).batch(0)
    full = {k: torch.from_numpy(v) for k, v in full.items()}
    n_text = S - 6
    with torch.no_grad():
        _, cache = T.prefill(cfg, params, {"patches": full["patches"],
                                           "tokens": full["tokens"][:, :n_text]},
                             max_seq=S + 1)
        got, _ = T.decode_logits(cfg, params, cache, full["tokens"][:, n_text:], max_seq=S + 1)
        x = T._embed_inputs(cfg, params, full)
        pos = T.make_positions(cfg, B, S + 1, "cpu").clone()
        assert pos[:, 0, S].tolist() == [S - 6 + 2] * 3  # side = int(sqrt(6)) = 2
        pos[:, :, S] = S  # the decode's streams
        h, _ = T._trunk(cfg, params, x, pos, None)
        want = L.logits_local(params["embed"], h[:, -1:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_serve_step_is_decode_step(scan_layers):
    serve_step_is_decode_step(ARCH, scan_layers)


# ---------------------------------------------------------------------------
# The W = 4 trainer against the reference's bundle.
# ---------------------------------------------------------------------------

W, TRAIN_STEPS, LR = 4, 3, 0.05
SHAPE = dict(seq_len=32, global_batch=8)
QSGD_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
               wire_format="compressed", error_feedback=True)

REFERENCE = r"""
import json
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import comms as jcomms
from repro.core.types import CommConfig
from repro.data.pipeline import SyntheticBatches
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
cells = json.loads('CELLS_JSON')


def by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


cfg = get_config(cells["arch"]).reduced()
shape = InputShape("train", cells["seq_len"], cells["global_batch"], "train")
jb = build_bundle(cfg, make_test_mesh(data=4, model=1), CommConfig(**cells["comm"]),
                  momentum_sgd(0.0), shape, seed=0, cache=False)
tr = Trainer(jb, SyntheticBatches(cfg, shape, seed=0), constant(cells["lr"]), log_every=1)
st = tr.init()
with jcomms.capture() as log:
    st = tr.fit(st, 1)
st = tr.fit(st, cells["steps"] - 1, start_step=1)
print("REF " + json.dumps({"loss": [h["loss"] for h in tr.history], "wire": by_tag_axes(log)}))
"""


def start_reference_series(arch: str, comm: dict) -> subprocess.Popen:
    """The reference's W = 4 series of ``arch`` in a subprocess with W host
    devices (started before the module's tests so that it runs beside
    them)."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    cells = dict(arch=arch, comm=comm, lr=LR, steps=TRAIN_STEPS, **SHAPE)
    return subprocess.Popen([sys.executable, "-c",
                             REFERENCE.replace("CELLS_JSON", json.dumps(cells))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def series_matches_reference(proc: subprocess.Popen, arch: str, comm: dict) -> None:
    cfg = get_config(arch).reduced()
    shape = InputShape("train", SHAPE["seq_len"], SHAPE["global_batch"], "train")
    bundle = build_bundle(cfg, CommConfig(**comm), opt.momentum_sgd(0.0), shape, n_workers=W,
                          seed=0, device="cpu", noise=_noise)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(LR), log_every=1)
    tr.fit(bundle.init_state(reference_params(arch, False)[3]), TRAIN_STEPS)
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    want = json.loads(out.split("REF ", 1)[1])
    np.testing.assert_allclose([h["loss"] for h in tr.history], want["loss"], rtol=1e-4)
    assert _by_tag_axes(bundle.logs["train"]) == pytest.approx(want["wire"], rel=1e-12)


def stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    proc = start_reference_series(ARCH, QSGD_EF)
    yield proc
    stop(proc)


def test_trainer_series_matches_reference(_reference_run):
    series_matches_reference(_reference_run, ARCH, QSGD_EF)


@pytest.mark.parametrize("arch", NEW)
def test_worker_and_microbatch_splits_slice_every_key(arch):
    """W = 2 workers of 2 microbatches each: the step's loss is the mean of
    the four forward losses on the batch's rows, each key (patches or
    frames, tokens, labels) sliced alike."""
    cfg = get_config(arch).reduced()
    shape = InputShape("train", 16, 8, "train")
    bundle = build_bundle(cfg, CommConfig(), opt.sgd(), shape, n_workers=2, seed=0,
                          device="cpu", microbatch=2)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticBatches(cfg, shape).batch(0).items()}
    parts = bundle._split(batch)
    assert [set(p) for p in parts] == [set(batch)] * 2
    for w, part in enumerate(parts):
        for k, v in part.items():
            assert torch.equal(v, batch[k][4 * w:4 * (w + 1)]), k
    with torch.no_grad():
        want = np.mean([float(T.forward_loss(cfg, params, {k: v[r:r + 2] for k, v in
                                                           batch.items()})[0])
                        for r in (0, 2, 4, 6)])
    _, m = bundle.train_step(bundle.init_state(tree_map(torch.clone, params)), batch, 0.0)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The full-width tree, the refusals, the launchers.
# ---------------------------------------------------------------------------


def test_full_width_param_tree_matches_reference():
    got = full_width_tree_matches_reference(ARCH)
    assert got["frontend_proj"] == (1536, 1536) and got["embed/embedding"] == (151936, 1536)
    assert got["blocks/0/attn/wk"] == (28, 1536, 2, 128)  # stacked over 28 layers
    count = sum(int(np.prod(s)) for s in got.values())
    assert 1.5e9 < count < 1.6e9


@pytest.mark.parametrize("upd,err", [
    (dict(mrope_sections=(16, 16, 16)), ValueError),  # 48 pairs, not hd/2 = 64
    (dict(modality="audio"), NotImplementedError),  # audio frames need the encoder
    (dict(is_encoder_decoder=True, encoder_layers=2), NotImplementedError),  # no frames
    (dict(modality="video"), NotImplementedError),
    (dict(family="rwkv"), NotImplementedError),
])
def test_unported_options_are_refused(upd, err):
    with pytest.raises(err):
        check_ported(get_config(ARCH).with_updates(**upd))


def test_train_launcher_runs_qwen2_vl(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                              "--workers", "2", "--seq-len", "16", "--global-batch", "4",
                              "--warmup", "1", "--comm", "qsgd"]) == 0
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_launcher_runs_qwen2_vl(capsys):
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
                              "20", "--batch", "2", "--decode", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 20x2: ")
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)
