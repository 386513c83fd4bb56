"""Atomic, async checkpoints of a training state, as the reference's
``repro/checkpoint/checkpoint.py``, on the same on-disk layout::

    <dir>/step_000000123/
        manifest.json       step, tree description, and per leaf its path,
                            file, dtype and shape
        leaf_00000.npy ...  one file per leaf

* **Atomicity**: written to ``step_X.tmp``, then renamed; a crash mid-write
  never corrupts the newest checkpoint (restore sees only complete dirs).
* **Async**: ``save_async`` copies the leaves to host memory at once and
  writes them on a worker thread; ``wait_pending`` joins the writers.
* **Retention**: the newest ``keep`` checkpoints stay.

Leaves are taken in ``jax.tree_util``'s order, the one
``optim/adamw.py::_leaves`` follows: dict keys sorted, lists, tuples and
``AdamWState``'s fields (step, m, v) in order; paths are written as the
reference writes them (``opt/.m/embed``), so either package restores the
other's checkpoints. numpy has no bf16, so a bf16 leaf is stored as its bits
(``u2``) with the dtype in the manifest, and restored through
``torch.int16`` → ``.view(torch.bfloat16)``: torch alone, bit for bit.

**A sharded state** (``placements=`` and ``mesh=``: each leaf this rank's
shard, cut by those placements, as ``shard_tree`` cuts): ``save`` gathers
every leaf whole, rank 0 writes the files an unsharded save writes, then
all ranks meet at a barrier; ``save_async`` gathers at the call (collectives
cannot run on the writer thread) and only rank 0's write is in the
background; ``restore`` reads the whole leaves on every rank and cuts its
shards; ``latest_step`` is rank 0's, on every rank. The files are
interchangeable with unsharded ones, as the reference's resharding restore
promises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (_coordinate, _local_slice, gather_tree,
                                              placements_by_leaf, whole_shape)
from repro_torch.optim.adamw import AdamWState, _leaves, _rebuild

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

_PENDING: List[threading.Thread] = []

# manifest dtype name -> torch dtype (the names numpy gives, and the
# reference writes)
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# stored as same-width unsigned ints (numpy cannot hold them), as the reference
_BITS = {torch.bfloat16: (torch.int16, np.uint16), torch.float16: (torch.int16, np.uint16)}


def _paths(tree, prefix: str = "") -> List[str]:
    """Leaf paths in leaf order, as the reference's ``_leaf_paths`` spells
    them (a NamedTuple field is ``.name``)."""
    def join(part):
        return f"{prefix}/{part}" if prefix else str(part)

    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], join(k))]
    if isinstance(tree, AdamWState):
        return [p for name, v in zip(tree._fields, tree) for p in _paths(v, join("." + name))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, join(i))]
    return [prefix]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array (a copy), bf16/f16 as their bits."""
    t = t.detach()
    if t.dtype in _BITS:
        signed, unsigned = _BITS[t.dtype]
        return t.view(signed).cpu().numpy().view(unsigned)
    return t.cpu().numpy().copy()


def _snapshot(state):
    leaves = _leaves(state)
    for t in leaves:
        if t.dtype not in _NAMES:
            raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return ([_to_host(t) for t in leaves], [_NAMES[t.dtype] for t in leaves], _paths(state))


def _describe(state) -> str:
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(state[k])}" for k in sorted(state)) + "}"
    if isinstance(state, AdamWState):
        return "AdamWState(" + ", ".join(_describe(v) for v in state) + ")"
    if isinstance(state, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in state) + "]"
    return "*"


def _whole(state, placements, mesh):
    """(the state made whole, whether this rank writes)."""
    if placements is None:
        return state, True
    return gather_tree(state, placements, mesh), dist.get_rank() == 0


def save(state: Any, ckpt_dir: str, step: int, *, keep: int = 3, placements=None,
         mesh=None) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    state, writer = _whole(state, placements, mesh)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if writer:
        arrays, dtypes, paths = _snapshot(state)
        path = _write(arrays, dtypes, paths, _describe(state), ckpt_dir, step, keep)
    if placements is not None:
        dist.barrier()
    return path


def save_async(state: Any, ckpt_dir: str, step: int, *, keep: int = 3, placements=None,
               mesh=None) -> None:
    """Copy the leaves to host memory now; write them on a background thread."""
    state, writer = _whole(state, placements, mesh)
    if not writer:
        return
    arrays, dtypes, paths = _snapshot(state)
    t = threading.Thread(target=_write,
                         args=(arrays, dtypes, paths, _describe(state), ckpt_dir, step, keep))
    t.start()
    _PENDING.append(t)


def wait_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def _write(arrays, dtypes, paths, tree_str, ckpt_dir, step, keep) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": tree_str,
        "leaves": [
            {"path": p, "file": f"leaf_{i:05d}.npy", "dtype": dt, "shape": list(a.shape)}
            for i, (p, dt, a) in enumerate(zip(paths, dtypes, arrays))
        ],
    }
    for i, a in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"), ignore_errors=True)


def _list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str, *, mesh=None) -> Optional[int]:
    """The newest complete checkpoint's step; with a ``mesh``, rank 0's
    (after its pending writes) on every rank."""
    if mesh is not None:
        wait_pending()
    steps = _list_steps(ckpt_dir)
    step = max(steps) if steps else None
    if mesh is not None:
        box = [step]
        dist.broadcast_object_list(box, src=0)
        step = box[0]
    return step


def _from_host(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    want = _DTYPES[dtype_name]
    if want in _BITS:
        t = torch.from_numpy(a.view(np.int16)).view(want)
    else:
        t = torch.from_numpy(a)
        if t.dtype != want:
            raise ValueError(f"a {t.dtype} file for a {dtype_name} leaf")
    return t.to(device)


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None, device=None,
            placements=None, mesh=None) -> Any:
    """The checkpoint (the newest, or ``step``) in the structure of ``like``,
    each leaf on its ``like`` leaf's device, or on ``device`` when given.
    With ``placements`` (and the ``mesh``), ``like`` holds this rank's
    shards: each whole leaf is read and cut to the rank's block."""
    cuts = [None] * len(_leaves(like))
    if placements is not None:
        cuts, coord = placements_by_leaf(like, placements), _coordinate(mesh)
    if step is None:
        step = latest_step(ckpt_dir, mesh=mesh)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _leaves(like)
    recs = manifest["leaves"]
    if len(recs) != len(like_leaves):
        raise ValueError(f"{d} holds {len(recs)} leaves, the state {len(like_leaves)}")
    out = []
    for rec, ref, pl in zip(recs, like_leaves, cuts):
        shape = list(ref.shape if pl is None else whole_shape(ref.shape, pl, mesh))
        if list(rec["shape"]) != shape:
            raise ValueError(f"{rec['path']}: shape {rec['shape']} in {d}, "
                             f"{shape} in the state")
        t = _from_host(np.load(os.path.join(d, rec["file"])), rec["dtype"], "cpu")
        if pl is not None:
            t = _local_slice(t, pl, mesh, coord).contiguous()
        out.append(t.to(ref.device if device is None else device))
    return _rebuild(like, iter(out))
