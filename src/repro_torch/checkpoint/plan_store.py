"""Compiled-plan persistence — warm a serving plan cache from disk.

A copy of the reference's ``repro/checkpoint/plan_store.py`` (numpy and
JSON only), in the same file format: a plan file either package wrote loads
in the other with bitwise arrays. The port's ``EngineConfig`` has no
``use_kernel`` (a CUDA tensor always runs the kernels), so that field of a
reference-written header is dropped on load; any other field the port does
not know is refused.

``ExecutionPlan`` / ``ShardedExecutionPlan`` are pure host-side artifacts
(numpy arrays + a frozen EngineConfig), so they round-trip losslessly through
a single ``.npz`` file: every tile array is stored under a namespaced key and
everything scalar rides in a JSON header entry. A restarted ``GNNServeEngine``
loads these instead of re-running the planner — the disk analogue of the
in-memory plan cache (and of AMPLE's host programming nodeslots once per
graph, not once per boot).

No pickle anywhere: headers are UTF-8 JSON stored as a uint8 array, tags are
fixed-width unicode, so files are inspectable and load with
``allow_pickle=False``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np

from repro_torch.core.degree_quant import DegreeQuantConfig
from repro_torch.core.message_passing import (
    EngineConfig,
    ExecutionPlan,
    ShardPlan,
    ShardedExecutionPlan,
)
from repro_torch.core.scheduler import EdgeTilePlan
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partition import Partition, ShardSubgraph

__all__ = ["save_plan", "load_plan", "PlanRecord"]

_PLAN_ARRAYS = ("gather_idx", "coeff", "seg_ids", "out_node", "node_ids", "edge_ids")


@dataclasses.dataclass(frozen=True)
class PlanRecord:
    """What ``load_plan`` returns: the plan plus optional sidecar state."""

    plan: Union[ExecutionPlan, ShardedExecutionPlan]
    graph: Optional[Graph]  # structure only (no features); None if not saved
    extra: Dict[str, Any]  # caller metadata (e.g. the serve-cache key)


# ------------------------------------------------------------------- encode
def _cfg_header(cfg: EngineConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["dq"] = dataclasses.asdict(cfg.dq)
    return d


def _plan_header(plan: ExecutionPlan) -> Dict[str, Any]:
    return {
        "fingerprint": plan.fingerprint,
        "graph_fp": plan.graph_fp,
        "num_nodes": plan.num_nodes,
        "num_edges": plan.num_edges,
        "modes": list(plan.mode_plans),
        "tiles": {
            mode: {
                tag: {
                    "num_nodes": p.num_nodes,
                    "edges_per_tile": p.edges_per_tile,
                    "segments_per_tile": p.segments_per_tile,
                    "total_edges": p.total_edges,
                }
                for tag, p in tag_plans.items()
            }
            for mode, tag_plans in plan.mode_plans.items()
        },
    }


def _pack_plan(plan: ExecutionPlan, prefix: str, arrays: Dict[str, np.ndarray]) -> None:
    arrays[f"{prefix}tags"] = np.asarray(plan.precision_tags, dtype="U8")
    for mode, tag_plans in plan.mode_plans.items():
        for tag, p in tag_plans.items():
            base = f"{prefix}p/{mode}/{tag}/"
            for name in _PLAN_ARRAYS:
                arrays[base + name] = getattr(p, name)


# ------------------------------------------------------------------- decode
# Fields of the reference's EngineConfig that the port leaves out.
_DROPPED_CFG_FIELDS = ("use_kernel",)


def _cfg_from_header(d: Dict[str, Any]) -> EngineConfig:
    d = {k: v for k, v in d.items() if k not in _DROPPED_CFG_FIELDS}
    unknown = sorted(set(d) - {f.name for f in dataclasses.fields(EngineConfig)})
    if unknown:
        raise ValueError(f"plan file's engine config has fields this EngineConfig lacks: {unknown}")
    d["dq"] = DegreeQuantConfig(**d["dq"])
    return EngineConfig(**d)


def _unpack_plan(
    header: Dict[str, Any], cfg: EngineConfig, prefix: str, z
) -> ExecutionPlan:
    tags = np.asarray(z[f"{prefix}tags"]).astype(str)
    # "pad" marks size-class padding nodes of an assembled union plan: they
    # belong to no precision group (their rows must stay zero through the
    # FTE), so they are excluded here exactly as assemble_union_plan does.
    groups = {
        tag: np.nonzero(tags == tag)[0]
        for tag in np.unique(tags)
        if tag != "pad"
    }
    mode_plans: Dict[str, Dict[str, EdgeTilePlan]] = {}
    for mode, tag_meta in header["tiles"].items():
        mode_plans[mode] = {}
        for tag, meta in tag_meta.items():
            base = f"{prefix}p/{mode}/{tag}/"
            arrays = {
                name: np.asarray(z[base + name])
                for name in _PLAN_ARRAYS
                if base + name in z
            }
            if "edge_ids" not in arrays:
                # Files written before the runtime-coefficient indirection:
                # structurally valid, but opted out of runtime coeffs
                # (every lane reads the -1 padding slot).
                arrays["edge_ids"] = np.full(
                    arrays["gather_idx"].shape, -1, np.int32
                )
            mode_plans[mode][tag] = EdgeTilePlan(
                **arrays,
                num_nodes=int(meta["num_nodes"]),
                edges_per_tile=int(meta["edges_per_tile"]),
                segments_per_tile=int(meta["segments_per_tile"]),
                total_edges=int(meta["total_edges"]),
            )
    return ExecutionPlan(
        fingerprint=header["fingerprint"],
        graph_fp=header["graph_fp"],
        num_nodes=int(header["num_nodes"]),
        num_edges=int(header["num_edges"]),
        cfg=cfg,
        precision_tags=tags,
        node_groups=groups,
        mode_plans=mode_plans,
    )


# ---------------------------------------------------------------------- API
def save_plan(
    path: str,
    plan: Union[ExecutionPlan, ShardedExecutionPlan],
    *,
    graph: Optional[Graph] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a compiled plan (and optionally its graph structure) to ``path``.

    ``graph`` stores topology only (indptr/indices — features are runtime
    inputs, not plan state); pass the *prepared* graph the plan was compiled
    for so a restarted server can rebuild an engine without re-preparing.
    ``extra`` is an arbitrary JSON-serialisable dict returned verbatim by
    ``load_plan`` (the serving layer stashes its cache key there).
    """
    arrays: Dict[str, np.ndarray] = {}
    header: Dict[str, Any] = {"version": 1, "extra": extra or {}}
    if isinstance(plan, ShardedExecutionPlan):
        header["kind"] = "sharded_plan"
        header["sharded"] = {
            "fingerprint": plan.fingerprint,
            "graph_fp": plan.graph_fp,
            "partition_fp": plan.partition_fp,
            "num_nodes": plan.num_nodes,
            "num_edges": plan.num_edges,
        }
        header["cfg"] = _cfg_header(plan.cfg)
        header["partition_kind"] = plan.partition.kind
        arrays["partition_starts"] = np.asarray(plan.partition.starts, np.int64)
        if plan.partition.order is not None:
            # non-contiguous (min-cut) assignment: the permutation is part of
            # the partition identity and must survive the round-trip
            arrays["partition_order"] = np.asarray(plan.partition.order, np.int64)
        arrays["tags"] = np.asarray(plan.precision_tags, dtype="U8")
        shard_headers = []
        for k, sp in enumerate(plan.shards):
            prefix = f"s{k}/"
            shard_headers.append(
                {
                    "fingerprint": sp.fingerprint,
                    "lo": sp.shard.lo,
                    "hi": sp.shard.hi,
                    "edge_range": (
                        list(sp.shard.edge_range)
                        if sp.shard.edge_range is not None
                        else None
                    ),
                    "graph_name": sp.shard.graph.name,
                    "plan": _plan_header(sp.plan),
                }
            )
            if sp.shard.edge_idx is not None:
                arrays[f"{prefix}edge_idx"] = np.asarray(
                    sp.shard.edge_idx, np.int64
                )
            arrays[f"{prefix}halo"] = np.asarray(sp.shard.halo, np.int64)
            arrays[f"{prefix}indptr"] = sp.shard.graph.indptr
            arrays[f"{prefix}indices"] = sp.shard.graph.indices
            _pack_plan(sp.plan, prefix, arrays)
        header["shards"] = shard_headers
    elif isinstance(plan, ExecutionPlan):
        header["kind"] = "plan"
        header["plan"] = _plan_header(plan)
        header["cfg"] = _cfg_header(plan.cfg)
        _pack_plan(plan, "", arrays)
    else:
        raise TypeError(f"cannot persist {type(plan).__name__}")
    if graph is not None:
        header["graph"] = {"num_nodes": graph.num_nodes, "name": graph.name}
        arrays["graph/indptr"] = graph.indptr
        arrays["graph/indices"] = graph.indices
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic publish, like checkpoint/
    return path


def _mmap_npz(path: str) -> Dict[str, np.ndarray]:
    """Read-only memmap views of every member of an uncompressed ``.npz``.

    ``np.load(..., mmap_mode=...)`` silently ignores the mode inside zip
    archives (each member would need its own offset), so the member data
    offsets are resolved by hand: ``np.savez`` stores members uncompressed
    (ZIP_STORED), meaning each ``.npy`` payload sits verbatim in the file at
    ``local header + magic/header`` and maps directly. Returns a plain dict
    — the ``z[key]`` / ``key in z`` surface ``_unpack_plan`` reads.
    """
    import zipfile

    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path}: member {info.filename!r} is compressed; "
                    "mmap_mode needs an uncompressed archive (np.savez)"
                )
            # Local file header: 30 fixed bytes, then filename + extra field
            # (their lengths live at offsets 26/28); the .npy stream follows.
            f.seek(info.header_offset)
            hdr = f.read(30)
            fn_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + 30 + fn_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"unsupported npy version {version} in {path}")
            if dtype.hasobject:
                raise ValueError(f"{path}: object arrays cannot be memmapped")
            name = info.filename
            if name.endswith(".npy"):
                name = name[: -len(".npy")]
            out[name] = np.memmap(
                path,
                dtype=dtype,
                shape=shape,
                order="F" if fortran else "C",
                mode="r",
                offset=f.tell(),
            )
    return out


def load_plan(path: str, *, mmap_mode: Optional[str] = None) -> PlanRecord:
    """Load a plan written by ``save_plan``; fingerprints round-trip exactly.

    ``mmap_mode="r"`` maps every tile array read-only straight out of the
    file instead of materialising it: large ``EdgeTilePlan`` arrays then
    cost address space and page cache, not private resident memory, which
    bounds warm-start RSS (plan files on big graphs rival the feature
    matrix). The returned arrays are views onto the file — read-only, so
    accidental mutation raises instead of silently corrupting the plan;
    copy before writing.
    """
    if mmap_mode is not None:
        if mmap_mode != "r":
            raise ValueError(f"mmap_mode must be 'r' or None, got {mmap_mode!r}")
        return _decode_record(path, _mmap_npz(path))
    with np.load(path, allow_pickle=False) as z:
        return _decode_record(path, z)


def _decode_record(path: str, z) -> PlanRecord:
    header = json.loads(bytes(np.asarray(z["header"]).tobytes()).decode("utf-8"))
    cfg = _cfg_from_header(header["cfg"])
    graph = None
    if "graph" in header:
        graph = Graph(
            indptr=np.asarray(z["graph/indptr"], np.int64),
            indices=np.asarray(z["graph/indices"], np.int32),
            num_nodes=int(header["graph"]["num_nodes"]),
            name=header["graph"]["name"],
        )
    if header["kind"] == "plan":
        plan: Union[ExecutionPlan, ShardedExecutionPlan] = _unpack_plan(
            header["plan"], cfg, "", z
        )
    elif header["kind"] == "sharded_plan":
        starts = np.asarray(z["partition_starts"], np.int64)
        order = (
            np.asarray(z["partition_order"], np.int64)
            if "partition_order" in z
            else None
        )
        # files from before the partitioner field default to the contiguous
        # edge-balanced kind (the only partitioner that existed then)
        part = Partition(
            starts=starts, order=order, kind=header.get("partition_kind", "edges")
        )
        tags = np.asarray(z["tags"]).astype(str)
        groups = {t: np.nonzero(tags == t)[0] for t in np.unique(tags)}
        shards = []
        for k, sh in enumerate(header["shards"]):
            prefix = f"s{k}/"
            halo = np.asarray(z[f"{prefix}halo"], np.int64)
            lo, hi = int(sh["lo"]), int(sh["hi"])
            local_g = Graph(
                indptr=np.asarray(z[f"{prefix}indptr"], np.int64),
                indices=np.asarray(z[f"{prefix}indices"], np.int32),
                num_nodes=(hi - lo) + int(halo.size),
                name=sh["graph_name"],
            )
            edge_range = sh.get("edge_range")
            sub = ShardSubgraph(
                index=k,
                lo=lo,
                hi=hi,
                halo=halo,
                local_ids=np.concatenate([part.owned(k), halo]),
                graph=local_g,
                edge_range=tuple(edge_range) if edge_range is not None else None,
                edge_idx=(
                    np.asarray(z[f"{prefix}edge_idx"], np.int64)
                    if f"{prefix}edge_idx" in z
                    else None
                ),
            )
            shards.append(
                ShardPlan(
                    fingerprint=sh["fingerprint"],
                    shard=sub,
                    plan=_unpack_plan(sh["plan"], cfg, prefix, z),
                )
            )
        meta = header["sharded"]
        plan = ShardedExecutionPlan(
            fingerprint=meta["fingerprint"],
            graph_fp=meta["graph_fp"],
            partition_fp=meta["partition_fp"],
            partition=part,
            num_nodes=int(meta["num_nodes"]),
            num_edges=int(meta["num_edges"]),
            cfg=cfg,
            precision_tags=tags,
            node_groups=groups,
            shards=tuple(shards),
        )
    else:
        raise ValueError(f"unknown plan kind {header['kind']!r} in {path}")
    return PlanRecord(plan=plan, graph=graph, extra=header.get("extra", {}))
