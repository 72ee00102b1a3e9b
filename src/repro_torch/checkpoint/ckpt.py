"""Checkpoints in the reference's format (counterpart of
``repro.checkpoint.ckpt``): the leaves of a tree, keyed by their
``flatten_with_paths`` path, in one ``arrays.npz``, and a ``manifest.json``
with the step, the tree's structure and the sorted keys.

A tensor is stored as its numpy array (bf16 as the 2-byte raw values numpy
keeps for it, ``|V2``, as the reference's bf16 arrays are stored); a
Python int (a step counter) as an int32 scalar, the reference's dtype.  So
a checkpoint of the same tree loads in either package.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_paths, unflatten_like

_BF16_RAW = np.dtype("V2")


def _write_atomic(path: str, writer, retries: int = 1) -> None:
    """Write ``path`` via a same-directory temp file and ``os.replace``.

    Readers see the old file or the complete new one, never a torn one.
    One retry absorbs a transient ``OSError``; the temp file is removed
    either way."""
    tmp = path + ".tmp"
    for attempt in range(retries + 1):
        try:
            with open(tmp, "wb") as f:
                writer(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return
        except OSError:
            if attempt >= retries:
                raise
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass


def _to_host(v: Any) -> np.ndarray:
    if isinstance(v, np.ndarray):  # a leaf as a checkpoint holds it
        return v
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RAW)
        return t.numpy()
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    raise TypeError(f"cannot checkpoint a {type(v).__name__}")


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def save(path: str, tree: Any, *, step: int = 0, extra: dict | None = None,
         group=None) -> None:
    """Atomic save: every file lands via temp + ``os.replace``, the arrays
    first and the manifest last.  The manifest is the checkpoint's validity
    marker, so a save killed midway leaves the previous checkpoint whole.
    Over ranks (``group``, a :class:`repro_torch.core.ranks.RankGroup`, on
    every rank with the same gathered ``tree``) rank 0 writes, and every rank
    returns after a barrier, once the checkpoint is whole."""
    if group is not None:
        if group.rank == 0:
            save(path, tree, step=step, extra=extra)
        group.barrier()
        return
    os.makedirs(path, exist_ok=True)
    host = {k: _to_host(v) for k, v in flatten_with_paths(tree).items()}
    # np.savez takes the open handle as-is (a bare path would grow .npz)
    _write_atomic(os.path.join(path, "arrays.npz"), lambda f: np.savez(f, **host))
    manifest = {"step": step, "treedef": f"PyTreeDef({_structure(tree)})",
                "keys": sorted(host), "extra": extra or {}}
    payload = json.dumps(manifest, indent=2).encode()
    _write_atomic(os.path.join(path, "manifest.json"), lambda f: f.write(payload))


def digest(tree: Any) -> dict[str, str]:
    """The SHA-256 of each leaf of ``tree`` as :func:`save` stores it (its
    dtype, shape and every byte), keyed by its path: two trees with equal
    digests write the same arrays, and the arrays of a saved checkpoint
    digest as the tree it was saved from.  Four leaves are copied and
    hashed at once (hashlib releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(v) -> str:
        a = _to_host(v)
        h = hashlib.sha256(f"{a.dtype.str} {a.shape}".encode())
        h.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        return h.hexdigest()

    flat = flatten_with_paths(tree)
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(flat, pool.map(one, flat.values())))


def _from_host(a: np.ndarray, like: Any, device, path: str) -> Any:
    if not isinstance(like, torch.Tensor):  # a step counter
        return int(a)
    if a.shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path!r}: shape {a.shape}, expected "
                         f"{tuple(like.shape)}")
    if a.dtype == _BF16_RAW:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device=like.device if device is None else device, dtype=like.dtype)


def restore(path: str, like: Any, device: str | torch.device | None = None, *,
            partial: bool = False) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each tensor leaf with
    ``like``'s shape and dtype, on ``device`` (default: the leaf's own;
    ``like`` may live on the ``meta`` device), each int leaf as an int.

    ``partial=True`` lets the checkpoint carry keys ``like`` does not ask
    for (they are ignored: the rejoin path leaves the stale comm state
    behind); keys ``like`` asks for must always exist."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = flatten_with_paths(like)
    ckpt_keys, tree_keys = set(manifest["keys"]), set(flat_like)
    missing_from_tree = sorted(ckpt_keys - tree_keys)  # saved, but not asked for
    absent_from_ckpt = sorted(tree_keys - ckpt_keys)  # asked for, never saved
    if absent_from_ckpt or (missing_from_tree and not partial):
        raise ValueError(
            f"checkpoint/tree key mismatch restoring {path!r}: "
            f"{len(missing_from_tree)} checkpoint key(s) absent from the "
            f"restore tree {missing_from_tree}; "
            f"{len(absent_from_ckpt)} restore-tree key(s) absent from the "
            f"checkpoint {absent_from_ckpt}")
    out = [_from_host(host[k], v, device, k) for k, v in flat_like.items()]
    return unflatten_like(like, out), manifest["step"]
