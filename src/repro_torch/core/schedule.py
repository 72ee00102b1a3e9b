"""Scheduling / pipelining of communication and computation (paper §VII;
counterpart of ``repro.core.schedule``, plain Python).

DAG cost model of one backward pass + gradient communication:

* sequential: all communication after the full backward (no overlap);
* WFBP [63,47]: layer l's all-reduce starts as soon as its gradient is
  ready, overlapping with layer l-1's computation;
* MG-WFBP [64]: WFBP + merging consecutive small tensors into buckets so
  the per-message latency term stops dominating;
* pipelined: the double-buffered staleness-1 schedule the trainer
  realizes (train/steps.py, ``CommConfig.overlap="pipelined"``): every
  (bucketized) message carries the PREVIOUS iteration's gradients, so it has
  no dependency on this iteration's compute and can start at t=0 — comm
  hides behind compute entirely, bounded only by the single-NIC serial comm
  time.  ``staleness=0`` is the flush variant: messages wait for their
  producer (WFBP-with-buckets starts), no gradient staleness.

The same bucket plan object drives the *runtime* (aggregate.make_bucket_plan)
— this model predicts the iteration time each plan implies (paper §VII
discussion).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import Link, allreduce_cost


@dataclass(frozen=True)
class LayerSpec:
    name: str
    grad_bytes: float
    backward_time: float  # seconds


def simulate_schedule(
    layers: list[LayerSpec],
    *,
    n_workers: int,
    link: Link = Link(),
    alg: str = "ring",
    mode: str = "wfbp",  # sequential | wfbp | mgwfbp | pipelined
    bucket_bytes: float = 0.0,
    staleness: int = 1,  # pipelined only: 1 = double-buffered, 0 = flush
    launch: float = 0.0,  # per-message fixed dispatch overhead (calibrated)
) -> dict:
    """Iteration time of backward+comm under the given schedule.

    Backward runs last-layer-first; communication of a (merged) bucket can
    start once every layer in it has produced its gradient — or, under the
    ``pipelined`` staleness-1 schedule, immediately (the message carries the
    previous iteration's gradients) — and messages serialize on the network
    link (single NIC model).  ``overlap_saving`` is always
    ``no_overlap_time - iter_time``, where ``no_overlap_time`` serializes the
    full backward and every message (the sequential bound), so the saving is
    comparable across every mode, 0 for ``sequential`` by construction.
    """
    # backward completes layer by layer (reverse order)
    t = 0.0
    ready = {}
    for spec in reversed(layers):
        t += spec.backward_time
        ready[spec.name] = t
    bwd_end = t

    def merge_buckets():
        out, cur, size = [], [], 0.0
        for s in reversed(layers):
            cur.append(s)
            size += s.grad_bytes
            if size >= bucket_bytes:
                out.append(cur)
                cur, size = [], 0.0
        if cur:
            out.append(cur)
        return out

    # build buckets + the start rule
    if mode == "sequential":
        # per-layer messages, none started before the whole backward is done
        buckets = [[s] for s in reversed(layers)]
        start_rule = "all"
    elif mode == "wfbp":
        buckets = [[s] for s in reversed(layers)]
        start_rule = "ready"
    elif mode == "mgwfbp":
        buckets = merge_buckets()
        start_rule = "ready"
    elif mode == "pipelined":
        buckets = merge_buckets() if bucket_bytes > 0 else [[s] for s in reversed(layers)]
        # staleness >= 1: every message is the previous iteration's grads —
        # no producer dependency, start at t=0; staleness 0 = flush variant
        start_rule = "immediate" if staleness >= 1 else "ready"
    else:
        raise ValueError(mode)

    net_free = 0.0
    total_comm = 0.0
    for bucket in buckets:
        nbytes = sum(s.grad_bytes for s in bucket)
        if start_rule == "all":
            ready_t = bwd_end
        elif start_rule == "immediate":
            ready_t = 0.0
        else:
            ready_t = max(ready[s.name] for s in bucket)
        start = max(ready_t, net_free)
        dur = allreduce_cost(alg, n_workers, nbytes, link) + launch
        net_free = start + dur
        total_comm += dur
    # a fully hidden comm tail still waits for the backward to finish
    finish = max(net_free, bwd_end)
    no_overlap = bwd_end + total_comm
    return {
        "iter_time": finish,
        "bwd_time": bwd_end,
        "comm_time": finish - bwd_end if finish > bwd_end else 0.0,
        "total_comm_time": total_comm,
        "n_messages": len(buckets),
        "overlap_saving": no_overlap - finish,
    }
