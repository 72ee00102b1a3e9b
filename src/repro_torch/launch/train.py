"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --reduced --steps 200 \\
        --comm topk_ef --opt momentum --lr 0.1 --workers 4 [--model 2] \\
        [--pod 2] [--pod-local] [--overlap pipelined --overlap-staleness 0] \\
        [--microbatch 4] [--zero1] [--local-steps 8] [--device cpu] \\
        [--ckpt-dir ckpts --ckpt-every 100] [--restore ckpts/step100]

The workers are stacked on one device (``--workers`` takes the place of
the reference's ``--data``: D workers per pod; ``--pod P`` lays out P pods
of them, W = P * D); ``--model M`` is the reference's model axis, M shards
stacked on the same device beside the workers (tensor-parallel layers, the
vocabulary-parallel loss, per-shard gradient buckets: W * M (worker, shard)
pairs); ``--fake-devices`` describes a jax mesh and has no port.
``--cache-dir`` (default ``$REPRO_TORCH_CACHE_DIR``) is the persistent
cache of :mod:`repro_torch.core.compilecache`: a later
launch on the same toolchain and card loads the kernel libraries and the
bundle's booked wire instead of building them.  Comm presets
are :data:`COMM_PRESETS`, the reference's dry-run table (``pod_local_sgd``:
BSP inside each pod, local SGD across pods every 8 steps);
``--local-steps``, ``--bucket-mb``, ``--pod-local`` and ``--overlap`` (with
``--overlap-staleness``; ``--microbatch`` sets the pipeline's depth) tweak
the preset.  ``--zero1`` shards the optimizer state over all W workers,
under every scheme.  The data is the bigram stream for a text model with a
vocabulary of at most 4,096 tokens (the bigram table is vocab x vocab);
above, and for the vision and audio families (whose batches carry patch or
frame embeddings), ``SyntheticBatches``.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.core.types import CommConfig

#: the reference's named comm presets (``repro.launch.dryrun.COMM_PRESETS``)
COMM_PRESETS = {
    "dense_bsp": CommConfig(),
    "topk_ef": CommConfig(
        compressor="topk", compressor_kwargs={"ratio": 0.01},
        error_feedback=True, momentum_correction=0.9, bucket_mb=32,
    ),
    "qsgd": CommConfig(compressor="qsgd", compressor_kwargs={"levels": 16}, bucket_mb=32),
    "signsgd_mv": CommConfig(compressor="signsgd", bucket_mb=32),
    "local_sgd": CommConfig(sync="local", local_steps=8),
    "ring_manual": CommConfig(collective="ring", bucket_mb=32),
    # multi-pod: BSP inside each pod, local SGD across pods every 8 steps
    "pod_local_sgd": CommConfig(pod_local=True, local_steps=8),
}

#: largest vocabulary the bigram source serves (its table is vocab x vocab)
BIGRAM_MAX_VOCAB = 4096


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true", help="reduced smoke-scale variant")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--comm", default="dense_bsp", choices=sorted(COMM_PRESETS))
    p.add_argument("--opt", default="momentum", choices=("sgd", "momentum", "adamw"))
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--workers", type=int, default=1, help="data-parallel workers per pod")
    p.add_argument("--pod", type=int, default=0, help="pods P (W = P x --workers)")
    p.add_argument("--model", type=int, default=1, help="model-axis shards M")
    p.add_argument("--microbatch", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--pod-local", action="store_true")
    p.add_argument("--local-steps", type=int, default=0)
    p.add_argument("--bucket-mb", type=float, default=-1.0)
    p.add_argument("--overlap", default="", choices=("", "sequential", "pipelined"))
    p.add_argument("--overlap-staleness", type=int, default=1, choices=(0, 1))
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--restore", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=os.environ.get("REPRO_TORCH_CACHE_DIR", ""),
                   metavar="DIR",
                   help="persistent cache of kernel libraries and booked wire "
                        "(default: $REPRO_TORCH_CACHE_DIR)")
    args = p.parse_args(argv)
    if args.cache_dir:
        from repro_torch.core import compilecache

        compilecache.configure(args.cache_dir)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import BigramSource, SyntheticBatches
    from repro_torch.optim.optimizers import adamw, momentum_sgd, sgd, zero1
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.steps import build_bundle
    from repro_torch.train.trainer import Trainer

    pods = max(args.pod, 1)
    n_workers = pods * args.workers
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    comm = COMM_PRESETS[args.comm]
    upd = {}
    if args.pod_local:
        upd["pod_local"] = True
    if args.local_steps:
        upd["local_steps"] = args.local_steps
    if args.bucket_mb >= 0:
        upd["bucket_mb"] = args.bucket_mb
    if args.overlap:
        upd["overlap"] = args.overlap
        upd["overlap_staleness"] = args.overlap_staleness
    if upd:
        comm = comm.with_updates(**upd)

    shape = InputShape("train", args.seq_len, args.global_batch, "train")
    opt = {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw}[args.opt]()
    if args.zero1:
        opt = zero1(opt, n_workers)
    bundle = build_bundle(cfg, comm, opt, shape, n_workers=n_workers, seed=args.seed,
                          device=args.device, clip_norm=args.clip_norm,
                          microbatch=args.microbatch, pods=pods, model=args.model)
    print(f"{n_workers} workers ({pods} pods x {args.workers}) x {args.model} model shards, "
          f"{args.comm}: "
          f"{len(bundle.bucket_plan.buckets)} buckets, {bundle.opt.name}")
    if cfg.vocab <= BIGRAM_MAX_VOCAB and cfg.modality == "text":
        src = BigramSource(cfg.vocab, seed=args.seed)

        class Data:
            def batch(self, step):
                return src.batch(step, shape.global_batch, shape.seq_len)

        data = Data()
    else:
        data = SyntheticBatches(cfg, shape, seed=args.seed)

    trainer = Trainer(bundle, data, warmup_cosine(args.lr, args.warmup, args.steps),
                      ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
                      log_every=max(1, args.steps // 20))
    start = 0
    if args.restore:
        state, start = trainer.restore(args.restore)
        print(f"restored step {start} from {args.restore}")
    else:
        state = trainer.init(args.seed)
    trainer.fit(state, args.steps, start_step=start)
    for row in trainer.history:
        print(f"step {row['step']:5d} loss {row['loss']:.4f} "
              f"ce {row['ce']:.4f} aux {row['aux']:.4f} wall {row['wall']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
