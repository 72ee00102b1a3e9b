"""qwen2-vl-2b and seamless-m4t-large-v2 (reduced) on the card against the
port's own CPU result (f32, TF32 off).  Every test here is ``gpu``-marked
and skips off the card; the module imports no jax, so it runs on a machine
with the port alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_vlm_encdec_card.py

* One trainer step at W = 2: qwen2-vl under ``qsgd_kernel`` EF on the
  int8 compressed wire (exactly ``qsgd_ef`` once per worker and bucket and
  ``int8_acc`` once per bucket), seamless under ``signsgd_packed`` EF
  (exactly ``sign_pack`` once per worker and bucket and ``sign_vote`` once
  per bucket); the loss within rtol 1e-4 of the CPU's.
* A prefill (patches or frames, then tokens) and 4 greedy decode steps
  through ``build_serve``: the last hidden state and every cache leaf
  (``enc_out`` among them) within rtol 1e-4 / atol 1e-5 x max of the CPU's,
  ``pos`` exact, the greedy tokens equal; no port kernel launched.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle, build_serve
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import flatten_with_paths, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


#: (arch, comm, the launches of one step at W = 2 given the bucket count)
CELLS = [
    ("qwen2-vl-2b", dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                         wire_format="compressed", error_feedback=True),
     lambda nb: {"qsgd_ef": 2 * nb, "int8_acc": nb}),
    ("seamless-m4t-large-v2", dict(compressor="signsgd_packed", wire_format="compressed",
                                   error_feedback=True),
     lambda nb: {"sign_pack": 2 * nb, "sign_vote": nb}),
]


def _step(arch: str, comm: dict, device):
    cfg = get_config(arch).reduced()
    shape = InputShape("train", 32, 4, "train")
    bundle = build_bundle(cfg, CommConfig(**comm), opt.momentum_sgd(0.0), shape, n_workers=2,
                          seed=0, device=device)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(0.05), log_every=1)
    tr.fit(bundle.init_state(T.init_params(cfg, seed=0, device="cpu")), 1)
    return tr.history[-1], len(bundle.bucket_plan.buckets)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,comm,launches", CELLS, ids=[c[0] for c in CELLS])
def test_trainer_step_on_card_launches_its_kernels(cuda, arch, comm, launches):
    ops.reset_launches()
    on_card, nb = _step(arch, comm, cuda)
    want = launches(nb)
    assert ops.LAUNCHES == {k: want.get(k, 0) for k in ops.LAUNCHES}
    on_cpu, _ = _step(arch, comm, "cpu")
    np.testing.assert_allclose(on_card["loss"], on_cpu["loss"], rtol=1e-4)


def _serve(cfg, params, batch, device, steps: int):
    sb = build_serve(cfg, InputShape("t", 24 + steps, 2, "decode"), device)
    last, cache = sb.prefill_step(params, batch)
    first = {k: v.clone() for k, v in flatten_with_paths(cache).items()}
    tok, toks = torch.from_numpy(batch["tokens"][:, :1]).to(device), []
    for _ in range(steps):
        tok, cache = sb.serve_step(params, cache, tok)
        toks.append(tok.cpu())
    return last.cpu(), {k: v.cpu() for k, v in first.items()}, torch.cat(toks, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_prefill_and_decode_on_card_match_cpu(cuda, arch):
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = SyntheticBatches(cfg, InputShape("p", 24, 2, "prefill"), seed=1).batch(0)
    want_last, want_cache, want_toks = _serve(cfg, params, batch, "cpu", 4)
    ops.reset_launches()
    last, cache, toks = _serve(cfg, tree_map(lambda t: t.to(cuda), params), batch, cuda, 4)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    np.testing.assert_allclose(last.numpy(), want_last.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want_last.abs().max()))
    assert list(cache) == list(want_cache)
    assert ("enc_out" in cache) == cfg.is_encoder_decoder
    for k, want in want_cache.items():
        if k.endswith("pos"):
            assert torch.equal(cache[k], want), k
        else:
            np.testing.assert_allclose(cache[k].numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(want.abs().max()), err_msg=k)
    assert torch.equal(toks, want_toks)
