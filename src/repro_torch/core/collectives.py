"""Hand-written all-reduce schedules on the stacked worker axis
(counterpart of ``repro.core.collectives``: ``ring_allreduce``,
``rhd_allreduce`` and ``allreduce``; its ``xla`` schedule, one psum, is the
running sum of ``aggregate``'s dense route).

The reference writes each schedule out of ``ppermute`` hops inside
``shard_map``, so its sums are associated hop by hop.  On one card the W
workers are rows of a (W, m) stack, so each schedule here computes what
its hops would: the same additions in the same association, in the stack's
dtype (a bf16 schedule rounds after every hop, as the reference's does),
and books every hop as a ``ppermute`` of one worker's hop payload.  The
stack is zero-padded to a multiple of W, as the reference pads each
worker's vector; ``rhd`` works on it in place.  A schedule runs over the
rows it is given, the workers of one axis: the D workers of one pod's
aggregation round, or the P pod rows of pod-local SGD's parameter
average, which stand for the hops every data index runs over the pods
(their rows are equal inside a pod); the records take their axes from
``comms.over``.  Under a rank group the other ranks' rows are moved in
first (``comms.fill_rows``) and every rank runs the same hops on the
gathered stack, so the sums stay bitwise; hop-by-hop sends between the
ranks are a later slice (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.core import comms


def padded_len(n: int, n_workers: int) -> int:
    """Length of a worker's vector padded to a multiple of W."""
    return -(-n // n_workers) * n_workers


def ring_allreduce(stack: torch.Tensor, n: int) -> torch.Tensor:
    """Bandwidth-optimal ring: W - 1 reduce-scatter hops, then W - 1
    all-gather hops.  Chunk c starts on worker c - 1 and every later worker
    adds its own chunk c to the running sum it receives."""
    W, m = stack.shape
    if W == 1:
        return stack[0, :n]
    chunks = stack.reshape(W, W, m // W)  # (worker, chunk, element)
    c = torch.arange(W, device=stack.device)
    val = chunks[(c - 1) % W, c]
    for s in range(1, W):
        comms.book_ppermute(val[0], W)
        val = val + chunks[(c - 1 + s) % W, c]
    for _ in range(W - 1):  # circulate the finished chunks
        comms.book_ppermute(val[0], W)
    return val.reshape(-1)[:n]


def rhd_allreduce(stack: torch.Tensor, n: int) -> torch.Tensor:
    """Recursive halving-doubling (W a power of two): log2 W halving steps in
    which worker i keeps one half of its live segment and adds its partner
    i ^ bit's copy of it, then log2 W doubling steps that gather the
    reduced segments.  Overwrites ``stack``."""
    W, m = stack.shape
    if W == 1:
        return stack[0, :n]
    if W & (W - 1):
        raise ValueError(f"rhd requires power-of-two workers, got {W}")
    off, size, bit = [0] * W, m, W >> 1
    while bit:
        half = size // 2
        comms.book_ppermute(stack[0, :half], W)
        for i in range(W):  # the halves a pair keeps are disjoint: in place
            lo = off[i] + (half if i & bit else 0)
            stack[i, lo:lo + half] += stack[i ^ bit, lo:lo + half]
            off[i] = lo
        size, bit = half, bit >> 1
    out = torch.empty(m, dtype=stack.dtype, device=stack.device)
    for i in range(W):
        out[off[i]:off[i] + size] = stack[i, off[i]:off[i] + size]
    while size < m:  # the doubling hops move copies only
        comms.book_ppermute(stack[0, :size], W)
        size *= 2
    return out[:n]


def allreduce(stack: torch.Tensor, n: int, impl: str) -> torch.Tensor:
    """Sum of the (W, m) stack's rows (their first n elements) by schedule
    ``impl``, "ring" or "rhd"."""
    return {"ring": ring_allreduce, "rhd": rhd_allreduce}[impl](comms.fill_rows(stack), n)
