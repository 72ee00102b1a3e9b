"""Bucketed gradient aggregation over W stacked workers (counterpart of
``repro.core.aggregate``).

    a = e*decay + g;  c = C(a);  e = a - C(a);  agg = mean_w decode(c_w)

On one card the W data-parallel workers are a leading tensor axis, so a
round is split in two halves.  :meth:`AggregationRound.add` is one worker's
send side: EF and compression of each bucket, the int8 codes written
straight into that worker's row of the round's (W, n) wire stack.
:meth:`AggregationRound.finish` is the receive side: the booked all-gather
of the stack and one widening-accumulate kernel per bucket.  The trainer
calls ``add`` right after each worker's backward, so W full f32 gradients
never live at once; :func:`aggregate_buckets` runs both halves over
already-stacked (W, n) gradients.

Three reductions are ported (churn and integrity arguments stay out):

* dense mean (no compressor, dense wire): a booked f32 all-reduce;
* ``wire_format="compressed"`` with an ``int8_acc`` compressor:
  ``_compressed_reduce`` -> ``_int8_code_reduce`` (kernels ``qsgd`` then
  ``int8_acc``);
* the same with error feedback: the fused-EF gate (kernels ``qsgd_ef``
  then ``int8_acc``), with each worker's residual updated in place.

The ported compressor fuses EF into its kernel (``compress_ef_p``), so the
reference's general ``feedback.pre_compress``/``post_compress`` composition
is not reached and not ported; :func:`repro_torch.core.types.validate`
rejects error feedback without a compressor.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core.compression.base import (
    compress_p,
    get_compressor,
    runtime_knob_values,
    runtime_knobs,
)
from repro_torch.core.types import CommConfig
from repro_torch.kernels import ops
from repro_torch.utils.tree import flatten_with_paths

f32 = torch.float32

#: noise(step, worker, bucket, n) -> (n,) f32 uniform draws in [0, 1)
Noise = Callable[[int, int, int, int], torch.Tensor]


@dataclass(frozen=True)
class Bucket:
    name: str
    #: (leaf_index, size) segments concatenated into this bucket
    segments: tuple[tuple[int, int], ...]
    size: int
    compressor_name: str
    compressor_kwargs: tuple  # hashable kv pairs


@dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]

    def compressor(self, b: Bucket):
        return get_compressor(b.compressor_name, **dict(b.compressor_kwargs))

    def knob_values(self) -> tuple[dict, ...]:
        """Per-bucket runtime compressor knob values (qsgd levels)."""
        return tuple(runtime_knob_values(self.compressor(b)) for b in self.buckets)


def plan_signature(plan: BucketPlan) -> tuple:
    """Structural identity of a plan: segment layout plus the compressor
    family per bucket, runtime knob values removed."""
    out = []
    for b in plan.buckets:
        traced = set(runtime_knobs(plan.compressor(b)))
        static_kw = tuple(kv for kv in b.compressor_kwargs if kv[0] not in traced)
        out.append((b.name, b.segments, b.size, b.compressor_name, static_kw))
    return tuple(out)


def _rule_for(comm: CommConfig, path: str) -> tuple[str, dict]:
    for sub, name, kwargs in comm.per_tensor_rules:
        if sub in path:
            return name, kwargs
    return comm.compressor, dict(comm.compressor_kwargs)


def make_bucket_plan(comm: CommConfig, grads_abstract: Any) -> BucketPlan:
    """Static bucketing from leaf shapes (any tree whose leaves have
    ``.shape``).  As in the reference, buckets follow the sorted path order
    and segment indices count positions in that order."""
    items = sorted(flatten_with_paths(grads_abstract).items())
    buckets: list[Bucket] = []
    if comm.bucket_mb <= 0:
        for i, (path, leaf) in enumerate(items):
            name, kw = _rule_for(comm, path)
            n = int(np.prod(leaf.shape))
            buckets.append(Bucket(path, ((i, n),), n, name, tuple(sorted(kw.items()))))
    else:
        cap = int(comm.bucket_mb * 1024 * 1024 / 4)
        kw = tuple(sorted(comm.compressor_kwargs.items()))
        cur: list[tuple[int, int]] = []
        cur_size = 0
        for i, (path, leaf) in enumerate(items):
            n = int(np.prod(leaf.shape))
            if cur and cur_size + n > cap:
                buckets.append(Bucket(f"bucket{len(buckets)}", tuple(cur), cur_size,
                                      comm.compressor, kw))
                cur, cur_size = [], 0
            cur.append((i, n))
            cur_size += n
        if cur:
            buckets.append(Bucket(f"bucket{len(buckets)}", tuple(cur), cur_size,
                                  comm.compressor, kw))
    return BucketPlan(tuple(buckets))


def init_comm_state(comm: CommConfig, plan: BucketPlan, n_workers: int,
                    device: str | torch.device) -> dict[str, Any]:
    """Communication state of W workers: ``ef[i]`` is the (W, size) stack
    of bucket i's EF residuals, one row per worker."""
    state: dict[str, Any] = {"step": 0}
    if comm.error_feedback:
        state["ef"] = [torch.zeros((n_workers, b.size), dtype=f32, device=device)
                       for b in plan.buckets]
    return state


def gather_bucket(b: Bucket, leaves: list[torch.Tensor]) -> torch.Tensor:
    """One bucket's flat f32 vector from its leaves (f32 widening)."""
    parts = [leaves[i].reshape(-1).to(f32) for i, _ in b.segments]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _gather_buckets(plan: BucketPlan, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    return [gather_bucket(b, leaves) for b in plan.buckets]


def _scatter_buckets(plan: BucketPlan, bucket_vals: list[torch.Tensor],
                     leaves_like: list[torch.Tensor]) -> list[torch.Tensor]:
    new = list(leaves_like)
    for b, v in zip(plan.buckets, bucket_vals):
        off = 0
        for i, n in b.segments:
            new[i] = v[off:off + n].reshape(leaves_like[i].shape).to(leaves_like[i].dtype)
            off += n
    return new


def seeded_noise(seed: int, device: str | torch.device) -> Noise:
    """Default noise: uniform draws from a ``torch.Generator`` on ``device``
    seeded from (seed, step, worker, bucket), so any round of any worker can
    be redrawn alone.  On the shape-only ``meta`` device it allocates only."""
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device)

    def noise(step: int, worker: int, bucket: int, n: int) -> torch.Tensor:
        if gen is None:
            return torch.empty(n, dtype=f32, device=device)
        digest = hashlib.blake2b(f"{seed}/{step}/{worker}/{bucket}".encode(),
                                 digest_size=8).digest()
        gen.manual_seed(int.from_bytes(digest, "little") >> 1)
        return torch.rand(n, generator=gen, dtype=f32, device=device)

    return noise


def _wire_stack(n_workers: int, n: int, device) -> torch.Tensor:
    """(W, n) int8 wire stack whose rows start on 16-byte boundaries, so the
    kernels can use vector loads and stores on every row."""
    ld = -(-n // 16) * 16
    return torch.empty((n_workers, ld), dtype=torch.int8, device=device)[:, :n]


class AggregationRound:
    """One BSP aggregation round over W stacked workers.

    ``comm_state`` is updated in place (each worker's EF rows) and returned
    by :meth:`finish` with ``step`` advanced.  ``noise`` supplies the uniform
    draws of the stochastic compressors."""

    def __init__(self, comm: CommConfig, plan: BucketPlan, comm_state: dict[str, Any],
                 n_workers: int, noise: Noise, device: str | torch.device):
        self.comm, self.plan, self.state = comm, plan, comm_state
        self.n_workers, self.noise, self.device = n_workers, noise, torch.device(device)
        self.comps = [plan.compressor(b) for b in plan.buckets]
        self.knobs = plan.knob_values()
        for comp in self.comps:
            if comp is not None and (comm.wire_format != "compressed"
                                     or comp.wire_reduce != "int8_acc"):
                raise NotImplementedError(
                    f"only the int8_acc compressed wire is ported, not "
                    f"{comp.name!r} on the {comm.wire_format!r} wire")
        nb = len(plan.buckets)
        self._sums: list[torch.Tensor | None] = [None] * nb
        self._codes: list[torch.Tensor | None] = [None] * nb
        self._norms: list[torch.Tensor | None] = [None] * nb

    def add(self, w: int, bufs: Iterable[torch.Tensor]) -> None:
        """Send side of worker ``w``: ``bufs`` yields its flat f32 bucket
        vectors in plan order (a generator keeps one bucket alive at once)."""
        comm, step = self.comm, self.state["step"]
        ef = self.state.get("ef")
        for i, (b, comp, g) in enumerate(zip(self.plan.buckets, self.comps, bufs)):
            if comp is None:
                if self._sums[i] is None:
                    self._sums[i] = g.clone()
                else:
                    self._sums[i].add_(g)
                continue
            if self._codes[i] is None:
                self._codes[i] = _wire_stack(self.n_workers, b.size, self.device)
                self._norms[i] = torch.empty(self.n_workers, dtype=f32, device=self.device)
            u = self.noise(step, w, i, b.size).to(self.device)
            out = {"code": self._codes[i][w]}
            if ef is not None:
                # the fused-EF gate: one kernel pass yields the int8 wire
                # codes and worker w's new residual, written in place
                out["e"] = ef[i][w]
                c, _ = comp.compress_ef_p(u, g, ef[i][w], self.knobs[i], comm.ef_decay,
                                          out=out)
            else:
                c = compress_p(comp, u, g, self.knobs[i], out=out)
            self._norms[i][w] = c.payload["norm"][0]

    def finish(self) -> tuple[list[torch.Tensor], dict[str, Any]]:
        """Receive side: reduce every bucket to its worker mean."""
        W = self.n_workers
        # scalars filled on the device: a host-to-card copy would wait for it
        denom = torch.full((), float(W), dtype=f32, device=self.device)
        out = []
        with comms.tag("grad_agg"):
            for i, comp in enumerate(self.comps):
                if comp is None:
                    comms.book_psum(self._sums[i], W)
                    out.append(self._sums[i] / denom)
                    continue
                # _int8_code_reduce: codes at wire width, decode scale
                # norm_w / levels folded into each worker's weight
                cg = comms.all_gather_compressed({"code": self._codes[i]})["code"]
                ng = comms.all_gather(self._norms[i].reshape(W, 1)).reshape(-1)
                sg = torch.full((), self.knobs[i]["levels"], dtype=f32, device=self.device)
                out.append(ops.int8_weighted_sum(cg, ng / sg) / denom)
        self.state["step"] += 1
        return out, self.state


def aggregate_buckets(comm: CommConfig, plan: BucketPlan, bufs: list[torch.Tensor],
                      comm_state: dict[str, Any], noise: Noise
                      ) -> tuple[list[torch.Tensor], dict[str, Any]]:
    """One round over already-stacked gradients: ``bufs[i]`` is bucket i's
    (W, size) f32 stack.  Returns the per-bucket means and the state."""
    W = bufs[0].shape[0]
    rnd = AggregationRound(comm, plan, comm_state, W, noise, bufs[0].device)
    for w in range(W):
        rnd.add(w, [b[w] for b in bufs])
    return rnd.finish()
