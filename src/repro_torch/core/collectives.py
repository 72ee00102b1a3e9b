"""Hand-written all-reduce schedules on the stacked worker axis
(counterpart of ``repro.core.collectives``: ``ring_allreduce``,
``rhd_allreduce`` and ``allreduce``; its ``xla`` schedule, one psum, is the
running sum of ``aggregate``'s dense route).

The reference writes each schedule out of ``ppermute`` hops inside
``shard_map``, so its sums are associated hop by hop.  Here the W workers
are rows of a (W, m) stack, so each schedule computes what its hops would:
the same additions in the same association, in the stack's dtype (a bf16
schedule rounds after every hop, as the reference's does), and books every
hop as a ``ppermute`` of one worker's hop payload.  The stack is
zero-padded to a multiple of W, as the reference pads each worker's
vector; ``rhd`` works on it in place.  A schedule runs over the rows it is
given, the workers of one axis: the D workers of one pod's aggregation
round, or the P pod rows of pod-local SGD's parameter average, which stand
for the hops every data index runs over the pods (their rows are equal
inside a pod); the records take their axes from ``comms.over``.

Under a rank group (``comms.ranks``) the stack is the rank's own (W/R, m)
rows, and every hop whose partner is another rank's worker is a message
to that rank (:meth:`repro_torch.core.ranks.RankGroup.sendrecv`): the
ring's running chunk of the rank's last worker goes to the next rank at
every one of the 2(W - 1) hops, and rhd's halving and doubling steps over
a bit of the worker index above the rank's own exchange each worker's
segment with the partner rank.  Hops inside a rank are local.  Every rank
ends with the full sum, bitwise the stacked schedule's.
"""

from __future__ import annotations

import torch

from repro_torch.core import comms


def padded_len(n: int, n_workers: int) -> int:
    """Length of a worker's vector padded to a multiple of W."""
    return -(-n // n_workers) * n_workers


def ring_allreduce(stack: torch.Tensor, n: int) -> torch.Tensor:
    """Bandwidth-optimal ring: W - 1 reduce-scatter hops, then W - 1
    all-gather hops.  After hop s worker i holds the running sum of chunk
    i + 1 - s: what worker i - 1 sent it plus its own chunk (chunk c starts
    on worker c - 1)."""
    group, W, lo = comms.layout(stack)
    k, m = stack.shape
    if W == 1:
        return stack[0, :n]
    chunks = stack.reshape(k, W, m // W)  # (worker, chunk, element)
    rows, i = torch.arange(k, device=stack.device), torch.arange(lo, lo + k, device=stack.device)
    val = chunks[rows, (i + 1) % W]
    for s in range(1, W):
        comms.book_ppermute(val[0], W)
        sent = val[-1:] if group is None else _hop(group, val[-1:], s)
        val = torch.cat([sent, val[:-1]]) + chunks[rows, (i + 1 - s) % W]
    out = torch.empty((W, m // W), dtype=stack.dtype, device=stack.device)
    out[(i + 2) % W] = val  # finished: worker i holds chunk i + 2 - W
    for t in range(1, W):  # circulate the finished chunks
        comms.book_ppermute(val[0], W)
        if group is not None:  # stacked, every chunk is here already
            val = torch.cat([_hop(group, val[-1:], W - 1 + t), val[:-1]])
            out[(i + 2 - t) % W] = val
    return out.reshape(-1)[:n]


def _hop(group, last: torch.Tensor, tag: int) -> torch.Tensor:
    """One ring hop across the ranks: the rank's last worker's value goes
    to the next rank, and the previous rank's arrives for its first."""
    got = torch.empty_like(last)
    group.sendrecv([((group.rank + 1) % group.world, tag, last)],
                   [((group.rank - 1) % group.world, tag, got)])
    return got


def rhd_allreduce(stack: torch.Tensor, n: int) -> torch.Tensor:
    """Recursive halving-doubling (W a power of two): log2 W halving steps in
    which worker i keeps one half of its live segment and adds its partner
    i ^ bit's copy of it, then log2 W doubling steps that gather the
    reduced segments (worker i ends the halving with chunk i).  Overwrites
    ``stack``."""
    group, W, lo = comms.layout(stack)
    k, m = stack.shape
    if W == 1:
        return stack[0, :n]
    if W & (W - 1):
        raise ValueError(f"rhd requires power-of-two workers, got {W}")
    off, size, bit = [0] * k, m, W >> 1
    while bit:
        half = size // 2
        comms.book_ppermute(stack[0, :half], W)
        if bit >= k and group is not None:  # the partner is another rank's worker
            # the rank's workers share the bits from here up, so one offset
            keep = off[0] + (half if lo & bit else 0)
            give = off[0] + (0 if lo & bit else half)
            got = torch.empty((k, half), dtype=stack.dtype, device=stack.device)
            peer = group.rank ^ (bit // k)
            group.sendrecv([(peer, bit, stack[:, give:give + half])], [(peer, bit, got)])
            stack[:, keep:keep + half] += got
            off = [keep] * k
        else:
            for j in range(k):  # the halves a pair keeps are disjoint: in place
                lo_j = off[j] + (half if (lo + j) & bit else 0)
                stack[j, lo_j:lo_j + half] += stack[j ^ bit, lo_j:lo_j + half]
                off[j] = lo_j
        size, bit = half, bit >> 1
    out = torch.empty(m, dtype=stack.dtype, device=stack.device)
    for j in range(k):
        out[off[j]:off[j] + size] = stack[j, off[j]:off[j] + size]
    bit = 1
    while size < m:  # the doubling hops move copies only
        comms.book_ppermute(stack[0, :size], W)
        if bit >= k and group is not None:  # each worker sends its segment
            mine = (lo & ~(bit - 1)) * (m // W)
            theirs = ((lo ^ bit) & ~(bit - 1)) * (m // W)
            got = torch.empty((k, size), dtype=stack.dtype, device=stack.device)
            peer = group.rank ^ (bit // k)
            group.sendrecv([(peer, W + bit, out[mine:mine + size].expand(k, size))],
                           [(peer, W + bit, got)])
            out[theirs:theirs + size] = got[0]
        size, bit = size * 2, bit * 2
    return out[:n]


def allreduce(stack: torch.Tensor, n: int, impl: str) -> torch.Tensor:
    """Sum of the (W, m) stack's rows (their first n elements) by schedule
    ``impl``, "ring" or "rhd"; under a rank group ``stack`` is the rank's
    own rows."""
    return {"ring": ring_allreduce, "rhd": rhd_allreduce}[impl](stack, n)
