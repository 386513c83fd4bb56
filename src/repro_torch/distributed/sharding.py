"""Sharding of the LM zoo over a ``torch.distributed`` mesh: the rules for the
params, the optimiser state, the batches and the caches, and the activation
layouts a ``ShardingPolicy`` threads through the model.

The reference's ``repro/distributed/sharding.py``, on a (pod, data, model)
``DeviceMesh`` (``launch/mesh.py``):

* batch over ("pod", "data"); attention heads, FFN hidden, vocab and experts
  over "model" (tensor and expert parallelism); FSDP (ZeRO-3) shards one
  spare dimension of every large leaf over "data";
* ``mode="fsdp"``: no tensor parallelism, both axes act as data/ZeRO-3 axes.

**The data half.** ``_rule_for`` is the reference's name-based table, copied
with its ``FSDP_MIN_ELEMENTS`` threshold and its divisibility guard (with the
fsdp-pair fallback). ``param_shardings``, ``state_shardings``,
``batch_shardings`` and ``cache_shardings`` give, per leaf, a tuple of
placements, one per mesh dimension (``Shard(d)`` or ``Replicate()`` of
``torch.distributed.tensor``): the reference's ``PartitionSpec`` read per
mesh axis. DTensor is the vocabulary only: ``shard_tree`` cuts full tensors
into this rank's local shards, ``gather_tree`` puts them back together, and
the model runs on plain local tensors.

**The activation half.** ``ShardingPolicy`` keeps the reference's hooks
(``res``, ``logits``, ``qkv``, ``moe_groups``, ``ebuf``, ``ebuf_out``), but
on local tensors: each redistributes from the layout the previous operation
left to the reference's layout at that point. Between hooks the port picks
its own schedule, with explicit collectives on ``mesh.get_group(axis)``:
column-parallel projections give head-sharded q/k/v, ``wo`` and the MLP's
down-projection reduce over "model", FSDP leaves are all-gathered over their
axes before their unit runs and their gradients reduce-scattered after it.
Flash and the SSD are ``ctypes`` calls on ``data_ptr`` and the MoE's sort and
scatter have no DTensor strategies, so no DTensor reaches the model.

Gradients follow one convention: the gradient of an activation replicated
over an axis is the whole gradient, the same on every rank of that axis.
Where a replicated tensor feeds work that differs by rank (a column-parallel
projection, the K/V that each rank's query rows read) an ``_F`` step
all-reduces its gradient; where the ranks' partial products are summed (a
row-parallel projection, a vocab-parallel lookup) a ``_G`` step all-reduces
the forward and passes the gradient through. The token axes (the axes the
tokens are split over: the data axes in ``tp``, every axis in ``fsdp``)
each hold different tokens, so a leaf replicated over one of them has its
gradient all-reduced there after the backward (``reduce_grads``).

**Collectives.** Each collective has one wrapper here. bf16 data moves as
bytes; sums run in f32. gloo takes CUDA tensors for all-gather,
all-reduce and broadcast; for reduce-scatter, all-to-all and point-to-point
(``STAGED_ON_GLOO``) the wrapper always stages the block through page-locked
host memory on a gloo group. ``record_collectives`` logs each call's bytes
and host milliseconds.

Entry points under a policy take the global batch (the same on every rank,
as the reference's global arrays) and this rank's local params and caches
(``shard_tree``); they return local logits and caches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_size, data_axes, mesh_tp
from repro_torch.optim.adamw import _leaves

__all__ = [
    "FSDP_MIN_ELEMENTS",
    "STAGED_ON_GLOO",
    "NO_POLICY",
    "ShardingPolicy",
    "make_policy",
    "on_mesh",
    "param_shardings",
    "state_shardings",
    "batch_shardings",
    "cache_shardings",
    "cache_spec",
    "cache_layout",
    "replicated",
    "spec_to_placements",
    "local_shape",
    "whole_shape",
    "placements_by_leaf",
    "shard_tree",
    "gather_tree",
    "record_collectives",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "all_to_all",
]

# ------------------------------------------------------------------- trees
def _is_leaf(node) -> bool:
    if isinstance(node, (dict, list)):
        return False
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        return all(isinstance(n, int) for n in node)  # a shape tuple
    return not isinstance(node, tuple)


def _map(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists, tuples and
    NamedTuples; ``path`` joins keys and indices with "/", as the
    reference's ``_path_str``."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), path=f"{path}/{k}" if path else str(k))
                for k in tree}
    if not _is_leaf(tree):
        items = [_map(fn, v, *(r[i] for r in rest), path=f"{path}/{i}" if path else str(i))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(path, tree, *rest)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf if isinstance(leaf, tuple) else leaf.shape))


# ------------------------------------------------------------------- meshes
def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _dp_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def _norm(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis, a tuple of axes) as a tuple of axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_placements(spec, mesh) -> tuple:
    """A ``PartitionSpec``-like tuple (one entry per tensor dim: None, an axis
    name or a tuple of names) read per mesh axis: ``Shard(d)`` where tensor
    dim ``d`` names the axis, else ``Replicate()``."""
    out = []
    for a in _names(mesh):
        dims = [d for d, e in enumerate(spec) if a in _norm(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in _names(mesh))


# --------------------------------------------------------------- the rules
def _rule_for(path: str, cfg: ModelConfig, tp: int) -> Optional[Tuple]:
    """Partition spec for a parameter leaf, by name (None = replicate); the
    reference's table. Specs are written for the unstacked shape (leading
    unit axes are padded by the caller). "model" is the TP/EP axis; "data"
    entries are the FSDP (ZeRO-3) placement, always on the weight's input
    dim for column-parallel matrices and its output dim for row-parallel
    ones, so a use gathers the weight and never reduces activations. The
    caller strips "data" when fsdp is off or the leaf is small."""
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    ep = cfg.num_experts > 0 and cfg.num_experts % tp == 0
    ff_div = cfg.d_ff % tp == 0

    if parent == "experts" or "/experts/" in path:
        # stacked expert FFN [E, D, F] / [E, F, D]; FSDP on the contraction
        # dim. Non-EP (E % tp != 0): replicated over "model", FSDP on "data".
        if name in ("w_gate", "w_up", "w_in"):
            return ("model", "data", None) if ep else (None, "data", None)
        if name in ("w_down", "w_out"):
            return ("model", "data", None) if ep else (None, None, "data")
        return None
    if name == "router":
        return None
    if name == "embed":
        return ("model", "data")
    if name == "lm_head":
        return ("data", "model")
    if name in ("wq", "wk", "wv"):
        return ("data", "model")
    if name == "wo":
        return ("model", "data")
    if name == "bq":
        return ("model",)
    if name in ("bk", "bv"):
        return ("model",)
    # MLP
    if name in ("w_gate", "w_up", "w_in"):
        return ("data", "model") if ff_div else ("data", None)
    if name in ("w_down", "w_out"):
        return ("model", "data") if ff_div else (None, "data")
    if name in ("b_gate", "b_up", "b_in"):
        return ("model",) if ff_div else None
    # Mamba
    di_div = cfg.ssm_state > 0 and cfg.d_inner % tp == 0
    h_div = cfg.ssm_state > 0 and cfg.ssm_heads % tp == 0
    if name in ("wx", "wz"):
        return ("data", "model") if di_div else ("data", None)
    if name == "out_proj":
        return ("model", "data") if di_div else (None, "data")
    if name == "wdt":
        return (None, "model") if h_div else None
    if parent == "conv_x" and name == "w":
        return (None, "model") if di_div else None
    if parent == "conv_x" and name == "b":
        return ("model",) if di_div else None
    if name in ("A_log", "D", "dt_bias"):
        return ("model",) if h_div else None
    if parent == "norm_scale" and name == "scale":
        return ("model",) if di_div else None
    return None  # norms, small biases, B/C projections: replicate


FSDP_MIN_ELEMENTS = 1 << 20  # leaves below this stay replicated over "data"


def _param_spec(cfg: ModelConfig, path: str, shape: Tuple[int, ...], mesh, *, fsdp: bool,
                mode: str) -> Tuple:
    """The reference's ``param_shardings.assign`` for one leaf: its spec."""
    spec = tuple(_rule_for(path, cfg, mesh_tp(mesh)) or ())
    nd = len(shape)
    if mode == "fsdp":  # no TP: the FSDP dim spans both axes, model dims free
        spec = tuple(("data", "model") if ax == "data" else (None if ax == "model" else ax)
                     for ax in spec)
    if len(spec) < nd:  # stacked unit/layer leading axes -> replicate them
        spec = (None,) * (nd - len(spec)) + spec
    elif len(spec) > nd:
        spec = (None,) * nd
    size = 1
    for d in shape:
        size *= d
    if not fsdp or size < FSDP_MIN_ELEMENTS or "data" not in _names(mesh):
        spec = tuple(None if ax == "data" else ax for ax in spec)

    def ok(dim, ax):  # divisibility guard: drop axes that do not divide evenly
        if ax is None:
            return None
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= axis_size(mesh, a)
        if dim % n == 0:
            return ax
        if isinstance(ax, tuple) and dim % axis_size(mesh, ax[0]) == 0:
            return ax[0]  # fsdp pair: fall back to the single "data" axis
        return None

    return tuple(ok(dim, ax) for dim, ax in zip(shape, spec))


def param_shardings(cfg: ModelConfig, params_shape, mesh, *, fsdp: bool = True,
                    mode: str = "tp"):
    """Placements (one per mesh dim) for every leaf of ``params_shape``
    (tensors, arrays or shape tuples). With ``fsdp=True`` every large leaf
    also shards one spare dim over "data", so params and AdamW moments scale
    with the whole mesh; ``fsdp=False`` (the reference's own option) keeps
    only the TP/EP dims, so decode gathers no weight."""
    return _map(lambda p, leaf: spec_to_placements(
        _param_spec(cfg, p, _shape(leaf), mesh, fsdp=fsdp, mode=mode), mesh), params_shape)


def state_shardings(cfg: ModelConfig, state_shape: Dict, mesh, *, mode: str = "tp") -> Dict:
    """Train-state placements: the params rules for params and AdamW moments."""
    opt = state_shape["opt"]
    out = {
        "params": param_shardings(cfg, state_shape["params"], mesh, mode=mode),
        "opt": type(opt)(step=replicated(mesh), m=param_shardings(cfg, opt.m, mesh, mode=mode),
                         v=param_shardings(cfg, opt.v, mesh, mode=mode)),
        "step": replicated(mesh),
    }
    if "compress" in state_shape:
        out["compress"] = param_shardings(cfg, state_shape["compress"], mesh, mode=mode)
    return out


def _batch_axes(mesh, mode: str, b: int) -> Optional[Tuple[str, ...]]:
    """Largest axis combo that divides the batch dim evenly (the
    reference's ``ShardingPolicy._batch_axes``)."""
    dp = data_axes(mesh)
    if mode == "fsdp":
        for axes in (dp + ("model",), dp, dp[-1:]):
            n = 1
            for a in axes:
                n *= axis_size(mesh, a)
            if b % n == 0:
                return axes
        return None
    return dp if b % _dp_size(mesh) == 0 else None


def batch_shardings(cfg: ModelConfig, batch_shape: Dict, mesh, *, mode: str = "tp") -> Dict:
    """The batch's leading dim over the batch axes, the rest replicated."""
    out = {}
    for k, v in batch_shape.items():
        shape = _shape(v)
        out[k] = spec_to_placements((_batch_axes(mesh, mode, shape[0]),)
                                    + (None,) * (len(shape) - 1), mesh)
    return out


def cache_spec(name: str, shape: Tuple[int, ...], mesh, *, batch: int) -> Tuple:
    """The spec of one decode-cache leaf (``shape`` with its unit axis):
    K/V [U, B, L, KV, hd] batch over the data axes when divisible and the
    sequence L over "model"; int8 scales the same; Mamba states shard their
    heads / channels over "model"."""
    tp = mesh_tp(mesh)
    b_ax = data_axes(mesh) if batch % _dp_size(mesh) == 0 else None
    nd = len(shape)
    if name in ("k", "v", "cross_k", "cross_v") and nd == 5:
        return (None, b_ax, "model" if shape[2] % tp == 0 else None, None, None)
    if name in ("k_scale", "v_scale") and nd == 4:
        return (None, b_ax, "model" if shape[2] % tp == 0 else None, None)
    if name == "ssm" and nd == 5:  # [U, B, H, P, N]
        return (None, b_ax, "model" if shape[2] % tp == 0 else None, None, None)
    if name.startswith("conv_") and nd == 4:  # [U, B, K-1, C]
        return (None, b_ax, None, "model" if shape[3] % tp == 0 else None)
    return (None,) * nd


def cache_layout(name: str, shape: Tuple[int, ...], mesh, *, batch: int) -> Tuple:
    """One unit of a cache leaf's ``cache_spec`` as a layout: per tensor dim
    after the unit axis, the mesh axes over it (``ShardingPolicy.take`` and
    ``redistribute`` read it)."""
    return tuple(_norm(e) for e in cache_spec(name, shape, mesh, batch=batch))[1:]


def cache_shardings(cfg: ModelConfig, cache_shape, mesh, *, batch: int):
    """Decode-cache placements, leaf by leaf (``cache_spec``)."""
    return _map(lambda path, leaf: spec_to_placements(
        cache_spec(path.split("/")[-1], _shape(leaf), mesh, batch=batch), mesh), cache_shape)


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(_shape(shape))
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= int(mesh.size(i))
    return tuple(out)


def whole_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of the whole leaf whose rank block has ``shape``
    (``local_shape``'s inverse)."""
    out = list(_shape(shape))
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] *= int(mesh.size(i))
    return tuple(out)


class _Placed:
    """One leaf's placements, a leaf of its own for ``_leaves``."""

    def __init__(self, placements):
        self.placements = placements


def placements_by_leaf(tree, placements) -> List:
    """Each leaf's placements, in the order ``optim.adamw._leaves`` takes
    the leaves of ``tree`` (dict keys sorted)."""
    return [p.placements for p in _leaves(_map(lambda _, leaf, pl: _Placed(pl), tree,
                                                placements))]


# --------------------------------------------------------- local shards
def _coordinate(mesh, coordinate=None) -> Tuple[int, ...]:
    if coordinate is not None:
        return tuple(coordinate)
    return tuple(mesh.get_local_rank(a) for a in _names(mesh))


def _local_slice(t: torch.Tensor, placements, mesh, coordinate) -> torch.Tensor:
    """This rank's block of a full tensor: mesh dims in order (an outer axis
    first where two shard one tensor dim, as ``("data", "model")``)."""
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = int(mesh.size(i))
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not split over "
                                 f"{_names(mesh)[i]} ({n})")
            step = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coordinate[i] * step, step)
    return t


def shard_tree(tree, placements, mesh, *, coordinate=None):
    """Each full leaf of ``tree`` (tensors or arrays) cut to this rank's local
    shard by its placements: contiguous copies, in the leaf's dtype and on
    its device. ``coordinate`` (the rank's index along each mesh dim)
    defaults to the mesh's own."""
    coord = _coordinate(mesh, coordinate)
    return _map(lambda _, leaf, pl: _local_slice(torch.as_tensor(leaf), pl, mesh,
                                                 coord).contiguous().clone(), tree, placements)


def gather_tree(tree, placements, mesh):
    """The full leaves back from every rank's local shards (``shard_tree``'s
    inverse): all-gathers over each sharded mesh dim, inner dims first."""

    def full(_, leaf, pl):
        for i in reversed(range(len(pl))):
            if isinstance(pl[i], Shard):
                leaf = torch.cat(all_gather(leaf.contiguous(), mesh.get_group(i)), pl[i].dim)
        return leaf

    return _map(full, tree, placements)


# ------------------------------------------------------------ collectives
STAGED_ON_GLOO = ("reduce_scatter", "all_to_all", "send/recv")
_log: Optional[List[Dict]] = None


@contextlib.contextmanager
def record_collectives():
    """Log every collective of this module inside the block: a list of
    ``{"op", "bytes", "ms"}`` (host milliseconds: a gloo call returns when
    its data has arrived)."""
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


@contextlib.contextmanager
def _logged(op: str, nbytes: int):
    if _log is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    _log.append({"op": op, "bytes": int(nbytes), "ms": (time.perf_counter() - t0) * 1e3})


def _staged(x: torch.Tensor, group) -> bool:
    """A CUDA block through a gloo group, for an op gloo may refuse on CUDA."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A half-precision block as bytes (movement only: gloo moves no bf16
    and no int16)."""
    return x.view(torch.uint8) if x.dtype in (torch.bfloat16, torch.float16) else x


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on all), in group-rank order."""
    x = x.contiguous()
    w = _bits(x)
    out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    with _logged("all_gather", x.nbytes * len(out)):
        dist.all_gather(out, w, group=group)
    return [o.view(x.dtype) for o in out]


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: the sum (or max) of ``x`` over the group, in f32 for
    half-precision blocks; the same bits on every rank."""
    y = x.detach().to(torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
                      else x.dtype).contiguous().clone()
    with _logged(f"all_reduce_{op}", y.nbytes):
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=group)
    return y.to(x.dtype)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x [n·c, ...] summed over the group; this rank's block [c, ...] (f32
    sums for half precision)."""
    n = dist.get_world_size(group)
    y = x.detach().to(torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
                      else x.dtype).contiguous()
    staged = _staged(y, group)
    src = _host(y) if staged else y
    out = src.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
    with _logged("reduce_scatter", y.nbytes):
        _reduce_scatter(out, src, group=group)
    return out.to(device=x.device, dtype=x.dtype)


# reduce_scatter_tensor is deprecated for reduce_scatter_single where it exists
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: block j goes to rank j; returns [n, ...], block j from
    rank j."""
    x = x.contiguous()
    w = _bits(x)
    staged = _staged(w, group)
    src = _host(w) if staged else w
    out = torch.empty_like(src)
    with _logged("all_to_all", x.nbytes):
        dist.all_to_all_single(out, src, group=group)
    return out.to(x.device).view(x.dtype)


class RingShift:
    """One ring step over ``group``: send ``x`` to the rank ``shift`` places
    on, receive the block of the rank ``shift`` places back. ``wait()``
    returns the received block (on ``x``'s device). A CUDA block through a
    gloo group moves through page-locked host memory, its copies on a side
    stream, so a product on the default stream runs while it moves."""

    def __init__(self, x: torch.Tensor, group, shift: int):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        self.dtype, self.device, self.t0 = x.dtype, x.device, time.perf_counter()
        w = _bits(x.contiguous())
        self.staged = _staged(w, group)
        self.nbytes = x.nbytes
        if self.staged:
            self.stream = torch.cuda.Stream(device=x.device)
            self.stream.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(self.stream):
                send = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
                send.copy_(w, non_blocking=True)
            self.stream.synchronize()
            self.recv = torch.empty_like(send)
        else:
            send, self.recv = w, torch.empty_like(w)
        self._keep = send
        dst = dist.get_global_rank(group, (r + shift) % n)
        src = dist.get_global_rank(group, (r - shift) % n)
        self.works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                             dist.P2POp(dist.irecv, self.recv, src, group)])

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        out = self.recv
        if self.staged:
            with torch.cuda.stream(self.stream):
                out = self.recv.to(self.device, non_blocking=True)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        if _log is not None:
            _log.append({"op": "send/recv", "bytes": self.nbytes,
                         "ms": (time.perf_counter() - self.t0) * 1e3})
        return out.view(self.dtype)


# ------------------------------------------------- autograd primitives
def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * step, step).contiguous()


def _rs_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim``."""
    return reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. Backward: this rank's block of the gradient,
    or with ``summed`` the reduce-scatter of the ranks' gradients (the
    gathered tensor fed work that differs by rank: an FSDP weight)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _rs_dim(g, ctx.group, ctx.dim), None, None, None
        return _chunk(g, ctx.group, ctx.dim), None, None, None


class _Slice(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor replicated over the group.
    Backward: the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.group), ctx.dim), None, None


def _move(x: torch.Tensor, group, src: int, dst: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    blocks = all_to_all(torch.stack(x.chunk(n, dst)), group)
    return torch.cat(blocks.unbind(0), src)


class _Move(torch.autograd.Function):
    """The group's shards move from tensor dim ``src`` to ``dst`` (one
    all-to-all). Backward: the inverse move."""

    @staticmethod
    def forward(ctx, x, group, src, dst):
        ctx.group, ctx.src, ctx.dst = group, src, dst
        return _move(x, group, src, dst)

    @staticmethod
    def backward(ctx, g):
        return _move(g, ctx.group, ctx.dst, ctx.src), None, None, None


class _F(torch.autograd.Function):
    """Identity; backward all-reduces the gradient over ``groups`` (the
    replicated input of work that differs by rank)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = all_reduce(g, grp)
        return g, None


class _G(torch.autograd.Function):
    """All-reduce (sum) over ``groups``; backward passes the gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        for grp in groups:
            x = all_reduce(x, grp)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _KVGather(torch.autograd.Function):
    """K or V [B, S', KV', hd] to the layout the rank's query rows read:
    all-gathered over ``group`` along ``dim`` (None: already whole), then cut
    to the first ``keep`` positions (the causal rows of this rank see no
    later key), contiguous without a copy beyond the gather's own. Backward:
    the gradient padded back to the whole sequence, then reduce-scattered
    over the group (with ``summed``: each rank's rows read the keys
    differently) or this rank's block of it; with no group, all-reduced over
    ``f_group`` when summed."""

    @staticmethod
    def forward(ctx, x, group, dim, keep, summed, f_group):
        pieces = all_gather(x, group) if group is not None else [x]
        ctx.group, ctx.dim, ctx.summed, ctx.f_group = group, dim, summed, f_group
        if group is not None and dim == 1:
            full = sum(p.shape[1] for p in pieces)
            ctx.full, ctx.keep = full, keep
            step = pieces[0].shape[1]
            return torch.cat(pieces[: keep // step], 1)
        ctx.full, ctx.keep = x.shape[1], keep
        if len(pieces) == 1:
            return x.narrow(1, 0, keep).contiguous()
        return torch.cat([p.narrow(1, 0, keep) for p in pieces], dim)

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[1] = ctx.full
        full = g.new_zeros(shape)
        full.narrow(1, 0, ctx.keep).copy_(g)
        if ctx.group is None:
            if ctx.summed:
                full = all_reduce(full, ctx.f_group)
            return full, None, None, None, None, None
        if ctx.summed:
            return _rs_dim(full, ctx.group, ctx.dim), None, None, None, None, None
        return _chunk(full, ctx.group, ctx.dim), None, None, None, None, None


class VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over vocab-sharded f32
    logits [..., V/tp] (this rank's columns start at ``offset``): the max and
    the exp-sum are reduced over ``group``, the target logit summed from its
    owner. The backward writes softmax - onehot into one logits-sized
    buffer with no collective (each rank owns its columns)."""

    @staticmethod
    def forward(ctx, logits, labels, group, offset):
        m = all_reduce(torch.amax(logits, dim=-1), group, op="max")
        se = all_reduce(torch.exp(logits - m[..., None]).sum(-1), group)
        lse = m + torch.log(se)
        local = labels - offset
        mine = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        tgt = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0] * mine
        tgt = all_reduce(tgt, group)
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine = ctx.saved_tensors
        grad = (logits - lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, idx[..., None], -(g * mine)[..., None])
        return grad, None, None, None


# --------------------------------------------------------------- policies
Spec = Tuple[Tuple[str, ...], ...]  # per tensor dim, the mesh axes over it (outer first)


class _NoPolicy:
    """Single device: every hook is the identity and every layout whole, so
    the model's one code path runs unsharded."""

    mesh = None
    mode = "tp"

    def bind(self, b, s):
        return self

    def compute_spec(self):
        return ((), (), ())

    def take(self, t, spec, first=0):
        return t

    def _coord(self, axis):
        return 0

    def res(self, x):
        return x

    def block_in(self, x):
        return x

    def logits(self, x):
        return x

    def qkv(self, q, k, v):
        return q, k, v

    def ebuf(self, xin):
        return xin

    def ebuf_out(self, y):
        return y

    def moe_groups(self, t):
        return 1

    def gather_params(self, tree, *path, lead=0):
        return tree


NO_POLICY = _NoPolicy()


@dataclasses.dataclass
class ShardingPolicy:
    """Activation layouts threaded through the model, on local tensors.

    mode="tp"   — tensor parallel over "model" (heads, FFN hidden, vocab,
                  experts) + FSDP and data parallel over "data".
    mode="fsdp" — no tensor parallelism: both axes act as data/ZeRO-3 axes;
                  activations shard batch over the data axes and "model",
                  or the sequence over "model"; weights are gathered per
                  unit.

    ``bind(b, s)`` fixes the global batch and sequence of one call (the
    entry points do it): the layouts depend on them, as the reference's
    constraints do on the arrays' shapes. ``placements``: the tree of
    placements the local params were cut with (``param_shardings``, given
    to ``shard_tree``), which the FSDP gathers, the gradient sums and the
    norm read; ``with_placements`` sets it."""

    mesh: Any
    seq_shard: bool = False  # sequence-shard residuals over "model" (tp mode)
    mode: str = "tp"
    batch: Optional[int] = None
    seq: Optional[int] = None
    placements: Any = None

    def __post_init__(self):
        if self.mode not in ("tp", "fsdp"):
            raise ValueError(f"unknown sharding mode {self.mode!r}")
        if "model" not in _names(self.mesh):
            raise ValueError(f"the mesh needs a 'model' axis, got {_names(self.mesh)}")

    # ---------------------------------------------------------- mesh facts
    def bind(self, b: int, s: int) -> "ShardingPolicy":
        return dataclasses.replace(self, batch=int(b), seq=int(s))

    def with_placements(self, placements) -> "ShardingPolicy":
        """This policy for params cut by ``placements``."""
        return dataclasses.replace(self, placements=placements)

    def _size(self, axis: str) -> int:
        return axis_size(self.mesh, axis)

    def _coord(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def tp(self) -> int:
        return mesh_tp(self.mesh)

    def _dp_size(self) -> int:
        return _dp_size(self.mesh)

    def _batch_axes(self, b: int):
        return _batch_axes(self.mesh, self.mode, b)

    def token_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks hold different tokens."""
        dp = data_axes(self.mesh)
        return dp + ("model",) if self.mode == "fsdp" else dp

    # ------------------------------------------------------------- layouts
    def _bax(self) -> Tuple[str, ...]:
        b, s = self.batch, self.seq
        ba = self._batch_axes(b)
        if ba is None:
            raise ValueError(f"a batch of {b} does not split over the mesh's batch axes "
                             f"{data_axes(self.mesh)} ({self.mode}); the port shards whole "
                             f"batches only")
        if self.mode == "fsdp" and "model" not in ba and not (s % self.tp == 0 and s > 1):
            raise ValueError(f"fsdp: a batch of {b} x {s} splits over neither the model axis "
                             f"nor its sequence")
        return ba

    def res_spec(self) -> Spec:
        """The residual stream [B, S, D] between blocks (the ``res`` hook's)."""
        ba, s, tp = self._bax(), self.seq, self.tp
        if self.mode == "fsdp":
            seq = ("model",) if "model" not in ba and s % tp == 0 and s > 1 else ()
            return (ba, seq, ())
        seq = ("model",) if self.seq_shard and s % tp == 0 and s > 1 else ()
        return (ba, seq, ())

    def compute_spec(self) -> Spec:
        """A block's input [B, S, D]: tp needs the whole sequence, replicated
        over "model", for its column-parallel projections."""
        if self.mode == "fsdp":
            return self.res_spec()
        return (self._bax(), (), ())

    def q_spec(self) -> Spec:
        """The reference's ``qkv`` layout of q [B, S, H, hd]: the sequence
        over "model" (context parallelism), batch over the data axes."""
        s, tp = self.seq, self.tp
        ba = tuple(a for a in self._bax() if a != "model")
        return (ba, ("model",) if s % tp == 0 and s > 1 else (), (), ())

    def take(self, t: torch.Tensor, spec: Spec, first: int = 0) -> torch.Tensor:
        """This rank's block of a global tensor laid out by ``spec`` (from
        tensor dim ``first``)."""
        for d, axes in enumerate(spec):
            for a in axes:
                n = self._size(a)
                step = t.shape[first + d] // n
                t = t.narrow(first + d, self._coord(a) * step, step)
        return t

    def redistribute(self, x: torch.Tensor, src: Spec, dst: Spec) -> torch.Tensor:
        """``x`` from layout ``src`` to ``dst``: per mesh axis (inner axes
        first) a move (one all-to-all), a gather or a slice."""
        cur = [list(e) for e in src]
        for a in reversed(_names(self.mesh)):
            sd = next((d for d, e in enumerate(cur) if a in e), None)
            dd = next((d for d, e in enumerate(dst) if a in e), None)
            if sd == dd:
                continue
            if sd is not None and cur[sd][-1] != a:
                raise ValueError(f"{a} is not the inner axis of dim {sd} in {src}")
            if sd is not None and dd is not None:
                x = _Move.apply(x, self.group(a), sd, dd)
            elif sd is not None:
                x = _Gather.apply(x, self.group(a), sd, False)
            else:
                x = _Slice.apply(x, self.group(a), dd)
            if sd is not None:
                cur[sd].pop()
            if dd is not None:
                cur[dd].append(a)
        if tuple(tuple(e) for e in cur) != tuple(tuple(e) for e in dst):
            raise ValueError(f"cannot redistribute {src} to {dst}")
        return x

    # ---------------------------------------------- the reference's hooks
    def res(self, x: torch.Tensor) -> torch.Tensor:
        """A block's output (compute layout) to the residual layout."""
        return self.redistribute(x, self.compute_spec(), self.res_spec())

    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream to a block's compute layout."""
        return self.redistribute(x, self.res_spec(), self.compute_spec())

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits leave ``lm_head`` in the reference's layout (tp: the vocab
        over "model" when the head is column-parallel; fsdp: the residual
        layout)."""
        return x

    def qkv(self, q, k, v, src: Optional[Spec] = None, causal: bool = True,
            kv_src: Optional[Spec] = None):
        """q to the sequence over "model" (context parallelism), K/V whole
        over "model" and, when q's rows are split and ``causal``, cut to the
        first ``a + S/tp`` positions this rank's rows ``[a, a + S/tp)`` read.
        ``src``: the layout q, k, v arrive in (default: the compute layout,
        heads whole); ``kv_src``: K/V's own layout where it differs
        (cross-attention: the encoder's positions, or a cache's)."""
        src = src or self.compute_spec()[:2] + ((), ())
        kv_src = kv_src or src
        qd = self.q_spec()
        q = self.redistribute(q, src, qd)
        split = bool(qd[1])
        # K/V's layout is q's without "model": gather it from wherever it is
        gdim = next((d for d, e in enumerate(kv_src) if "model" in e), None)
        group = self.group("model") if gdim is not None else None
        whole = k.shape[1] * (self.tp if gdim == 1 else 1)
        keep = (self._coord("model") + 1) * (self.seq // self.tp) if split and causal else whole
        if group is None and keep == whole and not split:
            return q, k, v
        f_group = self.group("model")
        k = _KVGather.apply(k, group, gdim, keep, split, f_group)
        v = _KVGather.apply(v, group, gdim, keep, split, f_group)
        return q, k, v

    def moe_groups(self, t: int) -> int:
        """Dispatch groups in this rank's tokens: one, since a rank's tokens
        are one token shard (the reference's groups are one per shard)."""
        return 1

    def ebuf(self, xin):
        """The dispatch buffer [G, E, C, D]: the rank's groups with every
        expert (fsdp: the experts' weights are gathered per unit), which is
        the reference's layout for its local block; tp runs the sharded MoE
        (``moe_sharded.py``) instead."""
        return xin

    def ebuf_out(self, y):
        return y

    # ------------------------------------------------- tensor parallelism
    def colpar(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated input of column-parallel work (its gradient summed
        over "model")."""
        return _F.apply(x, (self.group("model"),))

    def rowpar(self, y: torch.Tensor) -> torch.Tensor:
        """Row-parallel partial sums, summed over "model"."""
        return _G.apply(y, (self.group("model"),))

    def gather_model(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """A model-sharded leaf made whole, for work replicated over
        "model"."""
        return _Gather.apply(w, self.group("model"), dim, False)

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank partial sum (over this rank's channels) summed over
        "model" for per-rank work: the gradient, partial on each rank, is
        summed too."""
        return self.colpar(self.rowpar(x))

    def sum_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank partial sum over the tokens, summed over the token axes
        (the gradient passes to each rank's own tokens)."""
        return _G.apply(x, tuple(self.group(a) for a in self.token_axes()))

    # -------------------------------------------------------------- params
    def param_placements(self, *path):
        """The placements of the params (the subtree at ``path`` of keys)."""
        if self.placements is None:
            raise ValueError("the policy carries no param placements: give it those the params "
                             "were cut with, policy.with_placements(param_shardings(...))")
        node = self.placements
        for key in path:
            node = node[key]
        return node

    def gather_params(self, tree, *path, lead: int = 0):
        """FSDP leaves of ``tree``, the params' subtree at ``path``,
        all-gathered over their token axes (inner first; the gradient
        reduce-scattered); TP/EP dims stay sharded. ``lead``: leading dims
        the placements count that ``tree`` lacks (the unit axis of one
        unit's views)."""
        placements = self.param_placements(*path)
        tokens = set(self.token_axes())
        names = _names(self.mesh)

        def gather(_, leaf, pl):
            for i in reversed(range(len(pl))):
                if isinstance(pl[i], Shard) and names[i] in tokens:
                    leaf = _Gather.apply(leaf, self.mesh.get_group(i), pl[i].dim - lead, True)
            return leaf

        return _map(gather, tree, placements)

    def reduce_grads(self, grads):
        """Each local gradient summed over the token axes its leaf is
        replicated over (an FSDP leaf's was reduce-scattered by its
        gather)."""
        tokens = set(self.token_axes())
        names = _names(self.mesh)

        def red(_, g, pl):
            for i, p in enumerate(pl):
                if isinstance(p, Replicate) and names[i] in tokens:
                    g = all_reduce(g, self.mesh.get_group(i))
            return g

        return _map(red, grads, self.param_placements())

    def greedy(self, logits: torch.Tensor, vocab_size: int, padded: int) -> torch.Tensor:
        """Greedy tokens int64 [B] (every row of the global batch, on every
        rank) from this rank's logits [B', V'] (the vocab over "model" when
        V' < ``padded``): the local (value, index) maxima are all-gathered
        over "model" and the first maximum kept, as ``argmax`` over the whole
        vocab; then the rows are gathered over the batch's axes."""
        v_loc = logits.shape[-1]
        off = self._coord("model") * v_loc if v_loc != padded else 0
        valid = torch.arange(v_loc, device=logits.device) + off < vocab_size
        val, idx = torch.where(valid, logits, float("-inf")).max(dim=-1)
        idx = idx + off
        if v_loc != padded:
            model = self.group("model")
            vals, idxs = torch.stack(all_gather(val, model)), torch.stack(all_gather(idx, model))
            idx = torch.gather(idxs, 0, vals.argmax(0)[None])[0]
        for a in reversed(self.compute_spec()[0]):
            idx = torch.cat(all_gather(idx, self.group(a)), 0)
        return idx

    def counted_once(self, placements) -> bool:
        """Whether this rank's copy of a leaf with ``placements`` counts in
        a sum over the mesh: rank 0 of every axis the leaf is replicated
        over."""
        names = _names(self.mesh)
        return all(self._coord(names[i]) == 0 for i, p in enumerate(placements)
                   if isinstance(p, Replicate))


def make_policy(mesh, *, seq_shard: bool = False, mode: str = "tp") -> ShardingPolicy:
    return ShardingPolicy(mesh=mesh, seq_shard=seq_shard, mode=mode)


def on_mesh(policy) -> bool:
    """Whether ``policy`` shards over a mesh (``NO_POLICY`` and stand-in
    policies without a mesh run the single-device code)."""
    return getattr(policy, "mesh", None) is not None
