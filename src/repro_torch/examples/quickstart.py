"""Quickstart: train a small LM with compressed gradient aggregation
(DGC-style top-k + error feedback + momentum correction) over 4 workers,
then serve the trained model (the twin of ``examples/quickstart.py``).

Both train on a 4-way data x 2-way model layout: here the 4 workers and
the 2 model shards are stacked on one device (the parameters padded for 2,
each (worker, shard) compressing its shard-local buckets).  Serving runs
through ``build_serve`` at model-axis size 1 on the trained weights (the
reference serves them on its 4 x 2 mesh, the same function; serving under
the model axis is slice 20): prefill a prompt into the ring KV cache, then
16 greedy tokens.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.optim.optimizers import momentum_sgd
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.steps import build_bundle, build_serve
from repro_torch.train.trainer import Trainer

WORKERS = 4
MODEL = 2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    args = p.parse_args(argv)
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", seq_len=64, global_batch=16, kind="train")
    print(f"workers: {WORKERS} data-parallel x {MODEL} model shards, stacked on {args.device}")

    # the paper's pipeline: top-k sparsification [25,184] + error feedback
    # [132,138] + momentum correction [25], bucketed MG-WFBP style [64]
    comm = CommConfig(
        compressor="topk", compressor_kwargs={"ratio": 0.05},
        error_feedback=True, momentum_correction=0.9, bucket_mb=4,
    )
    bundle = build_bundle(cfg, comm, momentum_sgd(0.0), shape, n_workers=WORKERS,
                          device=args.device, model=MODEL)

    src = BigramSource(cfg.vocab, seed=0)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    trainer = Trainer(bundle, Data(), warmup_cosine(0.1, 20, 200), log_every=20)
    state = trainer.init()
    state = trainer.fit(state, 200)
    for row in trainer.history:
        print(f"step {row['step']:4d} loss {row['loss']:.4f}")
    assert trainer.history[-1]["loss"] < trainer.history[0]["loss"] * 0.8

    # --- serve the trained model ------------------------------------------------
    serve_shape = InputShape("serve", seq_len=64, global_batch=4, kind="decode")
    sb = build_serve(cfg, serve_shape, args.device)
    prompt = src.batch(999, 4, 32)["tokens"]
    last, cache = sb.prefill_step(state["params"], {"tokens": prompt})
    toks = [torch.as_tensor(prompt[:, -1:]).to(args.device)]
    for _ in range(16):
        nxt, cache = sb.serve_step(state["params"], cache, toks[-1])
        toks.append(nxt)
    gen = torch.cat(toks[1:], dim=1).cpu()
    print("generated:", gen[0].tolist())
    print("QUICKSTART OK")
    return gen


if __name__ == "__main__":
    main()
