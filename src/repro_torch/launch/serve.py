"""Serving launcher: prefill a batch of prompts, then decode N tokens greedily
from a zero token, as the reference's ``repro.launch.serve`` does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --prompt-len 1024 --batch 8 --decode 32 [--reduced] [--device cpu] [--seed 0] \\
        [--model 2] [--seq-par] [--restore ckpts/step100]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --prompt-len 1024 --batch 8 --decode 32      # dense GQA, the ring KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --prompt-len 1024 --batch 8 --decode 32      # MLA's latent cache, MoE decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --prompt-len 1024 --batch 8 --decode 32 --model 2 --seq-par

Any architecture the port serves runs: rwkv6-3b, qwen3-0.6b, glm4-9b,
qwen1.5-32b, gemma3-12b, qwen3-moe-30b-a3b, deepseek-v2-lite-16b,
hymba-1.5b, qwen2-vl-2b and seamless-m4t-large-v2.
Weights are random from ``--seed``, or the ``params`` of the checkpoint
that ``--restore`` names (``repro_torch.checkpoint``, the reference's
format: its other keys are left alone); prompts are ``SyntheticBatches``
(kind "prefill").  ``--model M`` serves on the reference's model axis,
its M shards stacked on the device: the parameters padded for M, the
context-parallel decode cache (each ring a multiple of M slots), the
vocabulary-sharded argmax.  ``--seq-par`` runs the sequence-parallel
prefill (dense models of global layers); its cache holds the prompt, so
the capacity is the prompt, as the reference's.  The reference's
``--data`` and ``--fake-devices`` lay the shards on a mesh of devices;
here one device holds every shard, so they are left out.  Prints the
prefill ms, the decode ms and tok/s, and the first sequence's tokens.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore as restore_ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.models.transformer import init_params
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import leaves


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, *, prompt_len: int, batch: int, decode: int,
        device: str | torch.device = "cuda", seed: int = 0, restore: str = "",
        model: int = 1) -> dict:
    """Build, prefill and decode (``model`` shards on the model axis; under
    ``cfg.seq_par`` the capacity is the prompt); print the launcher's
    lines and return
    ``{"prefill_ms", "decode_ms", "tok_per_s", "tokens" (B, decode) int32
    numpy, "last" (B, d) tensor, "cache", "cache_bytes" (the prefill
    cache's), "params", "bundle", "peak_bytes" (device memory high-water
    mark, weights included, None off the card)}``.  Times are host clock
    ending in a synchronize of the device."""
    device = torch.device(device)
    cap = prompt_len if cfg.seq_par else prompt_len + decode
    sb = build_serve(cfg, InputShape("serve", cap, batch, "decode"), device, msize=model)
    params = init_params(cfg, seed, device, msize=model)
    if restore:
        params = restore_ckpt(restore, {"params": params}, partial=True)[0]["params"]
        print(f"restored params from {restore}")
    if device.type == "cuda":  # the peak of serving, the weights included
        torch.cuda.reset_peak_memory_stats(device)
    prompts = SyntheticBatches(cfg, InputShape("p", prompt_len, batch, "prefill"),
                               seed=seed).batch(0)
    _sync(device)
    t0 = time.perf_counter()
    last, cache = sb.prefill_step(params, prompts)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
    print(f"prefill {prompt_len}x{batch}: {prefill_ms:.1f} ms")

    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    out = []
    t0 = time.perf_counter()
    for _ in range(decode):
        tok, cache = sb.serve_step(params, cache, tok)
        out.append(tok)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    tok_per_s = decode * batch / (decode_ms / 1e3)
    gen = torch.cat(out, dim=1).cpu().numpy() if out else np.zeros((batch, 0), np.int32)
    print(f"decoded {decode} tokens/seq in {decode_ms:.1f} ms ({tok_per_s:.1f} tok/s total)")
    print("sample:", gen[0].tolist())
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms, "tok_per_s": tok_per_s,
            "tokens": gen, "last": last, "cache": cache, "cache_bytes": cache_bytes,
            "params": params, "bundle": sb,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--decode", type=int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restore", default="")
    p.add_argument("--model", type=int, default=1,
                   help="model-axis shards, stacked on the device")
    p.add_argument("--seq-par", action="store_true",
                   help="sequence-parallel prefill (dense models of global layers)")
    args = p.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.seq_par:
        cfg = cfg.with_updates(seq_par=True)
    run(cfg, prompt_len=args.prompt_len, batch=args.batch, decode=args.decode,
        device=args.device, seed=args.seed, restore=args.restore, model=args.model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
