"""The recurrent families on the card: kernel ``wkv6_bwd`` and RWKV6's
training route, and the reduced hymba served on the card against the CPU.
Every test here is ``gpu``-marked and skips off the card; the module imports
no jax, so it runs on a machine with the port alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_recurrent_card.py

* ``wkv6_bwd`` (its two launches, ``wkv6_bwd_states`` and ``wkv6_bwd``)
  against both plain versions, ``ref.wkv6_backward`` and
  ``ref.wkv6_backward_chunked``, on the same card tensors: f32 and bf16 r,
  k, v, w holding 0, 1 and 1e-3, nonzero s0, dsT given and absent, hd 16,
  32, 64 and 80, S = 1, below a sub-chunk, one chunk (64) and one step
  either side of it, ragged; each gradient within rtol 1e-4 / atol 1e-5 x
  its largest magnitude, and two calls bitwise alike (no float atomics).
  ``wkv6_bwd_states`` alone against ``ref.wkv6_bwd_states``.
* ``rwkv_block`` on the card with ``use_kernel=True`` under autograd: the
  graph goes through ``WKV6Function`` (one ``wkv6``, one
  ``wkv6_bwd_states`` and one ``wkv6_bwd`` launch), and every leaf (wr,
  wk, wv, wg, w0, wd_A, wd_B, u and the ddlerp weights) gets the plain
  scan's gradient within rtol 1e-4 / atol 1e-5 x max (f32, TF32 off).
* The reduced hymba-1.5b through ``build_serve`` on the card (f32, TF32
  off) against the CPU: greedy tokens equal, the last hidden state and
  every cache leaf within rtol 1e-4 / atol 1e-5 x max.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops, ref
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    got, want = got.float(), want.float()
    bound = atol * float(want.abs().max()) + rtol * want.abs()
    assert bool(((got - want).abs() <= bound).all()), \
        (what, float((got - want).abs().max()), float(want.abs().max()))


def _inputs(B, S, H, hd, dtype, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev).mul_(0.5).to(dtype)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen, device=dev)) * 0.5 + 0.4
    w[:, ::7, :, ::3] = 0.0
    w[:, 1::5, :, 1::3] = 1.0
    w[:, 2::3, :, 2::3] = 1e-3
    u = (torch.randn((H, hd), generator=gen, device=dev) * 0.1).to(dtype)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev) * 0.1
    dy = torch.randn((B, S, H, hd), generator=gen, device=dev)
    dsT = torch.randn((B, H, hd, hd), generator=gen, device=dev) * 0.1
    return (r, k, v, w, u, s0), dy, dsT


L = ops.WKV6_BWD_CHUNK


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,dtype,with_dsT", [
    (1, 5, 2, 16, torch.float32, True), (2, 37, 3, 32, torch.float32, True),
    (2, 100, 2, 64, torch.bfloat16, True), (1, 61, 4, 80, torch.bfloat16, False),
    (2, 256, 4, 80, torch.float32, True), (2, 1, 2, 32, torch.bfloat16, True),
    (1, L - 1, 2, 64, torch.float32, True), (2, L, 2, 80, torch.bfloat16, True),
    (1, L + 1, 3, 80, torch.float32, False), (2, L + 1, 2, 64, torch.bfloat16, True),
    (1, 3 * L + 19, 2, 80, torch.bfloat16, True), (1, 3 * L + 19, 2, 80, torch.float32, True)])
def test_wkv6_bwd_matches_plain(cuda, B, S, H, hd, dtype, with_dsT):
    ins, dy, dsT = _inputs(B, S, H, hd, dtype, cuda, seed=S + hd)
    dsT = dsT if with_dsT else None
    ops.reset_launches()
    got = ops.wkv6_backward(*ins, dy, dsT)
    again = ops.wkv6_backward(*ins, dy, dsT)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6_bwd_states"] == 2 and ops.LAUNCHES["wkv6_bwd"] == 2
    want = ref.wkv6_backward(*ins, dy, dsT)
    twin = ref.wkv6_backward_chunked(*ins, dy, dsT)
    for name, g, a, wv, tw in zip(("r", "k", "v", "w", "u", "s0"), got, again, want, twin):
        assert g.dtype == torch.float32 and g.shape == wv.shape, name
        assert torch.equal(g, a), name
        _close(g, wv, f"d{name}")
        _close(g, tw, f"d{name} against the chunked twin")
    for name, g, wv in zip(("P", "D", "ds0"), ops.wkv6_bwd_states(*ins[:4], ins[5], dy, dsT),
                           ref.wkv6_bwd_states(*ins[:4], ins[5], dy, dsT)):
        _close(g, wv, f"{name} of wkv6_bwd_states")


@pytest.mark.gpu
def test_rwkv_block_trains_through_the_kernels(cuda):
    cfg = get_config("rwkv6-3b").reduced()
    params = T.init_params(cfg, seed=3, device=cuda)
    p = params["blocks"][0]["0"]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    for name in ("w0", "mu", "mu_base"):  # trained-like decays and mixes
        p[name] = torch.randn(p[name].shape, generator=gen, device=cuda) * 0.3
    names = ("wr", "wk", "wv", "wg", "w0", "wd_A", "wd_B", "u", "mu_base", "mu", "mix_A", "mix_B")
    x = torch.randn((2, 40, cfg.d_model), generator=gen, device=cuda)
    grads = {}
    for use_kernel in (True, False):
        leaves = {n: p[n].detach().clone().requires_grad_(True) for n in names}
        ops.reset_launches()
        out, _ = RW.rwkv_block(cfg, {**p, **leaves}, x, use_kernel=use_kernel)
        g = torch.autograd.grad((out * out).sum(), list(leaves.values()))
        torch.cuda.synchronize()
        want = {"wkv6": 1, "wkv6_bwd_states": 1, "wkv6_bwd": 1} if use_kernel else {}
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == want
        grads[use_kernel] = dict(zip(names, g))
    for n in names:
        assert bool(torch.count_nonzero(grads[False][n])), n
        _close(grads[True][n], grads[False][n], n)


@pytest.mark.gpu
def test_reduced_hymba_serves_on_the_card_as_on_the_cpu(cuda):
    cfg = get_config("hymba-1.5b").reduced()
    B, S, steps = 2, 24, 6
    shape = InputShape("t", S + steps, B, "decode")
    toks = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = T.init_params(cfg, seed=0, device="cpu")
        params = tree_map(lambda t, dev=dev: t.to(dev), params)
        sb = build_serve(cfg, shape, dev)
        last, cache = sb.prefill_step(params, {"tokens": toks})
        prefill_cache = tree_map(torch.clone, cache)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        seq = []
        for _ in range(steps):
            tok, cache = sb.serve_step(params, cache, tok)
            seq.append(tok.cpu())
        out[dev.type] = (last.cpu(), prefill_cache, cache, torch.cat(seq, 1))
    assert torch.equal(out["cpu"][3], out["cuda"][3])
    _close(out["cuda"][0], out["cpu"][0], "last hidden")
    for i in (1, 2):
        want = flatten_with_paths(out["cpu"][i])
        for k, v in flatten_with_paths(out["cuda"][i]).items():
            if k.endswith("pos"):
                assert torch.equal(v.cpu(), want[k]), k
            else:
                _close(v.cpu(), want[k], k)
