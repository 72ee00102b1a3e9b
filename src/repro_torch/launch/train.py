"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --reduced --steps 200 \\
        --comm topk_ef --opt momentum --lr 0.1 --workers 4 [--model 2] \\
        [--pod 2] [--pod-local] [--overlap pipelined --overlap-staleness 0] \\
        [--microbatch 4] [--zero1] [--local-steps 8] [--device cpu] \\
        [--ckpt-dir ckpts --ckpt-every 100] [--restore ckpts/step100] [--ranks 2]

The workers are stacked on one device (``--workers`` takes the place of
the reference's ``--data``: D workers per pod; ``--pod P`` lays out P pods
of them, W = P * D); ``--model M`` is the reference's model axis, M shards
stacked on the same device beside the workers (tensor-parallel layers, the
vocabulary-parallel loss, per-shard gradient buckets: W * M (worker, shard)
pairs); ``--fake-devices`` describes a jax mesh and has no port.
``--ranks R`` spreads the W workers over R ``torch.distributed`` processes
(gloo; W % R == 0; :mod:`repro_torch.core.ranks`): BSP (``ring_manual``
and ``collective="rhd"`` too, their hops sent between the ranks), local
and post-local SGD (``local_sgd`` with ``--local-steps``), pod-local SGD at
one pod (``pod_local_sgd`` without ``--pod``), D-PSGD and CHOCO-SGD
(``dpsgd``, ``choco_qsgd``), each under the sequential step and the
pipelined one (``--overlap pipelined``: each round on a communication
thread, so that its exchange overlaps the next microbatch), with churn and
integrity (``churn_qsgd``: each rank draws, validates and quarantines its
own workers):
without ``RANK`` in the environment this process starts the R rank
processes itself over a file store and exits non-zero, with every rank's
output, if any fails or overruns ``--rank-timeout``; under ``torchrun``
each process reads its rank from the environment.  ``--ranks 1`` runs the
stacked step in this process, the twin a ranked run is held against.
Under ``--ranks`` each process prints one ``rank-stats`` JSON line
(:func:`fit_with_stats`): its step ms, peak GiB, the bytes it sent and
received and its host seconds in ``torch.distributed`` a step (and those
its main thread waited for a pipelined round, ``exposed_s``), its own
workers' churn tallies a step, its kernel launches, the loss series (rank 0 logs), the wire captured over the run
and the wire booked for its workers, the bytes sent a step step by step;
with ``--ckpt-dir`` and
``--ckpt-every`` its end state is the checkpoint, every worker's rows
gathered into the reference's layout, and with ``--digest`` rank 0's line
carries that layout's SHA-256 digests (:func:`repro_torch.checkpoint.ckpt.
digest`) instead, so a run and its twin compare without writing one.  ``--deterministic`` runs under
``torch.use_deterministic_algorithms`` (and cuBLAS's fixed workspace), so
that a ranked run and its stacked twin on the card agree bitwise.
``--cache-dir`` (default ``$REPRO_TORCH_CACHE_DIR``) is the persistent
cache of :mod:`repro_torch.core.compilecache`: a later
launch on the same toolchain and card loads the kernel libraries and the
bundle's booked wire instead of building them.  Comm presets
are :data:`COMM_PRESETS`, the reference's dry-run table (``pod_local_sgd``:
BSP inside each pod, local SGD across pods every 8 steps) and the port's
own (``powersgd_ef``; ``signsgd_packed_ef``; ``qsgd_kernel_ef``;
``churn_qsgd``: churn and integrity; ``dpsgd`` and ``choco_qsgd``: gossip,
which the reference's launcher has no preset for);
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
import time

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
    # beyond the reference's table: PowerSGD, and churn with integrity on
    # the int8 wire (25% of workers out a round, 25% of payloads NaN)
    "powersgd_ef": CommConfig(compressor="powersgd", compressor_kwargs={"rank": 4},
                              error_feedback=True, bucket_mb=32),
    # 1-bit signs packed on the compressed wire, weighted vote, with EF
    "signsgd_packed_ef": CommConfig(compressor="signsgd_packed", wire_format="compressed",
                                    error_feedback=True),
    # the main path: QSGD 16 levels on the int8 compressed wire with EF
    # (one bucket per leaf, as the trainer phase of chip_smoke.py runs it)
    "qsgd_kernel_ef": CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                                 wire_format="compressed", error_feedback=True),
    "churn_qsgd": CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                             wire_format="compressed", error_feedback=True, bucket_mb=32,
                             dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25,
                             quarantine_limit=2),
    # gossip on the ring of workers: D-PSGD, and CHOCO-SGD sending QSGD-16
    # codes of x - x_hat to both neighbours
    "dpsgd": CommConfig(aggregator="gossip"),
    "choco_qsgd": CommConfig(aggregator="gossip", gossip_compress="choco",
                             compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                             bucket_mb=32),
}

#: largest vocabulary the bigram source serves (its table is vocab x vocab)
BIGRAM_MAX_VOCAB = 4096


def main(argv=None) -> int:
    t_main = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true", help="reduced smoke-scale variant")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the configuration's depth to this many layers (0: all)")
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
    p.add_argument("--ranks", type=int, default=0,
                   help="torch.distributed processes R over the workers (gloo; 1: the "
                        "stacked step); each prints a rank-stats line")
    p.add_argument("--rank-timeout", type=float, default=3600.0, metavar="S",
                   help="seconds the R rank processes may run")
    p.add_argument("--digest", action="store_true",
                   help="with --ranks: rank 0's rank-stats line carries the SHA-256 of every "
                        "array of the end state's checkpoint")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms only (bitwise-reproducible steps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=os.environ.get("REPRO_TORCH_CACHE_DIR", ""),
                   metavar="DIR",
                   help="persistent cache of kernel libraries and booked wire "
                        "(default: $REPRO_TORCH_CACHE_DIR)")
    args = p.parse_args(argv)
    from repro_torch.core import ranks as R

    if args.ranks > 1 and R.RANK_ENV not in os.environ:  # start the rank processes
        try:
            outs = R.launch("repro_torch.launch.train",
                            list(sys.argv[1:] if argv is None else argv), args.ranks,
                            timeout=args.rank_timeout)
        except R.RankFailure as e:
            print(e, file=sys.stderr)
            return 1
        for r, out in enumerate(outs):
            print(f"--- rank {r} of {args.ranks} ---\n{out}", end="")
        return 0
    if args.deterministic:  # cuBLAS reads its workspace setting at its start
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        import torch

        torch.use_deterministic_algorithms(True)
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
    if args.layers:
        cfg = cfg.with_updates(n_layers=args.layers)
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
    group = R.init_group(n_workers, args.device) if args.ranks > 1 else None
    if group is not None and group.world != args.ranks:
        raise ValueError(f"--ranks {args.ranks} under a world of {group.world} processes")
    device = args.device if group is None else group.device
    bundle = build_bundle(cfg, comm, opt, shape, n_workers=n_workers, seed=args.seed,
                          device=device, clip_norm=args.clip_norm,
                          microbatch=args.microbatch, pods=pods, model=args.model,
                          ranks=group)
    print(f"{n_workers} workers ({pods} pods x {args.workers}) x {args.model} model shards, "
          f"{args.comm}: "
          f"{len(bundle.bucket_plan.buckets)} buckets, {bundle.opt.name}"
          + ("" if group is None else f"; rank {group.rank} of {group.world}, workers "
             f"{group.lo}-{group.hi - 1} on {device}"))
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
    try:
        if args.ranks:
            fit_with_stats(trainer, state, args.steps, start, digest=args.digest,
                           t_main=t_main)
        else:
            trainer.fit(state, args.steps, start_step=start)
    finally:
        R.close_group()
    for row in trainer.history:
        print(f"step {row['step']:5d} loss {row['loss']:.4f} "
              f"ce {row['ce']:.4f} aux {row['aux']:.4f} wall {row['wall']:.1f}s")
    return 0


def fit_with_stats(trainer, state, steps: int, start: int, digest: bool = False,
                   t_main: float | None = None) -> None:
    """``steps`` trainer steps, one ``fit`` call each, timed on the host
    clock to the device's end; prints this process's ``rank-stats`` line.
    The kernel launches are counted from 0 before the first step, the
    warm-up step included (``launches``; ``launches_per_step`` is the last
    step's); the means a step leave the first out (``sent_per_step`` and
    ``received_per_step`` keep every step's bytes: a sync step moves more
    than an inner one); ``booked_per_worker`` is the train program's wire
    (the gossip program's under gossip).  With ``digest`` every
    rank gathers the end state's checkpoint tree after the steps and rank
    0's line carries its digests (``digest``; null on the other ranks).
    ``setup_s`` is the host seconds from ``t_main`` (the launcher's start,
    after the interpreter's) to the first step; ``digest_s`` the end
    state's gather and hashing.  ``tallies`` holds, a step, this process's
    own workers out in the step's last round (``dropped``) and the payloads
    quarantined and escalations in the step (a churn cell; {} else)."""
    import json

    import torch

    from repro_torch.core import comms
    from repro_torch.kernels import ops

    b = trainer.bundle
    group, dev = b.ranks, b.device
    program = "gossip" if "gossip" in b.wire else "train"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_ms, per_step, wire, tallies = [], [], {}, []
    counted = _tallies(state["comm"])
    setup_s = None if t_main is None else time.perf_counter() - t_main
    ops.reset_launches()
    for t in range(start, start + steps):
        before, launched = (group.stats.snapshot() if group else {}), dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        with comms.capture() as log:
            state = trainer.fit(state, 1, start_step=t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for r in log.records:
            key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
            wire[key] = wire.get(key, 0.0) + r.wire_bytes * r.mult
        after = group.stats.snapshot() if group else {}
        now = _tallies(state["comm"])
        tallies.append({"dropped": now.get("dropped", 0),
                        **{k: now[k] - counted[k] for k in ("quarantined", "escalated")
                           if k in now}} if now else {})
        counted = now
        per_step.append({**{k: after[k] - before[k] for k in after},
                         "launches": {k: v - launched.get(k, 0) for k, v in ops.LAUNCHES.items()
                                      if v - launched.get(k, 0)}})
    timed = per_step[1:] or per_step
    mean = {k: sum(s[k] for s in timed) / len(timed) for k in timed[0] if k != "launches"}
    booked = sum(b.wire[program].values())  # one worker's, by the reference's formulas
    digests, t_digest = None, time.perf_counter()
    if digest:
        from repro_torch.checkpoint.ckpt import digest as digest_of

        tree = b.checkpoint_tree(state)  # a gather over the ranks: every rank takes part
        digests = digest_of(tree) if trainer.writer else None
    print("rank-stats " + json.dumps({
        "rank": group.rank if group else 0, "world": group.world if group else 1,
        "workers": [b.workers.start, b.workers.stop], "device": str(dev), "step_ms": step_ms,
        "mean_step_ms": sum(step_ms[1:] or step_ms) / len(step_ms[1:] or step_ms),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                     else None),
        "per_step": mean, "sent_per_step": [s.get("sent", 0) for s in per_step],
        "received_per_step": [s.get("received", 0) for s in per_step],
        "launches_per_step": timed[-1]["launches"],
        "launches": {k: v for k, v in ops.LAUNCHES.items() if v}, "tallies": tallies,
        "loss": [row["loss"] for row in trainer.history], "wire": wire,
        "booked_per_worker": booked, "booked_for_rank": booked * len(b.workers),
        "digest": digests, "setup_s": setup_s,
        "digest_s": time.perf_counter() - t_digest if digest else None}), flush=True)


def _tallies(comm_state: dict) -> dict:
    """This process's own workers' churn and integrity counts so far: those
    out in the last round, and the quarantined payloads and escalations
    (the sums of its rows of ``quarantine_total`` and
    ``escalation_total``); {} without churn."""
    out = {}
    if "alive_prev" in comm_state:
        out["dropped"] = int((comm_state["alive_prev"] == 0).sum())
    for name, key in (("quarantined", "quarantine_total"), ("escalated", "escalation_total")):
        if key in comm_state:
            out[name] = int(comm_state[key].sum())
    return out


if __name__ == "__main__":
    sys.exit(main())
