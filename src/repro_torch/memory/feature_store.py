"""Chunked host-resident feature storage — the off-chip half of out-of-core.

The paper's evaluation graphs (Reddit 233K, Yelp 717K nodes) carry feature
matrices of several hundred MB; AMPLE keeps them in off-chip memory and
streams neighbour rows through the Feature Bank. ``FeatureStore`` is that
tier for the port: the matrix lives on the host, split into fixed-row chunks
held in **two representations**:

* ``f32`` chunks — raw rows, gathered by the float-precision plan stream;
* ``int8`` chunks — rows quantized under the *aggregation* scale (the same
  per-tensor symmetric calibration ``AmpleEngine`` computes on the dense
  matrix), gathered by the int8 plan stream so unprotected-node traffic moves
  1-byte elements end to end.

Bitwise contract: every value handed to the device is bit-identical to what
the in-memory path produces. The aggregation scale is computed chunk-wise on
the host with the op sequence of ``quantization.compute_scale_zp`` (max is
exact, the scalar divide and clamp are IEEE-exact), and chunk quantization
matches ``quantization.quantize`` element for element on the CPU and on the
card — both are tested.

A copy of the reference's ``repro/memory/feature_store.py`` (numpy). Two
additions serve the card: ``from_array(pin_memory=True)`` holds both
representations in page-locked host memory, so chunk uploads are DMA copies
with no host copy first; and ``stream_rows`` gives a representation as one
row-major array (a view of the chunks' storage), from which the prefetcher
gathers sparse rows and takes chunk views. ``memmap_dir`` backs both
representations with ``np.memmap`` files so host RSS stays bounded for
larger-than-RAM matrices.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FeatureStore", "default_chunk_rows"]

_INT8_MIN, _INT8_MAX = -128, 127
_EPS = np.float32(1e-8)


def default_chunk_rows(num_rows: int, dim: int, budget_bytes: int) -> int:
    """Pick a chunk row count for a feature budget: ~1/16 of the budget per
    f32 chunk (so the cache holds a meaningful working set and the last-chunk
    padding waste stays small), clamped to [256, 65536] and the matrix size."""
    if budget_bytes <= 0:
        target = 4096
    else:
        target = budget_bytes // max(16 * 4 * dim, 1)
    r = 256
    while r * 2 <= target and r < 65536:
        r *= 2
    return int(min(max(r, 256), max(num_rows, 1)))


def _host_array(shape, dtype, pin: bool) -> Tuple[np.ndarray, torch.Tensor]:
    """A zeroed host array and the tensor over the same memory, page-locked
    when ``pin``."""
    t = torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, pin_memory=pin)
    return t.numpy(), t


class FeatureStore:
    """Host-resident chunked feature matrix with f32 + int8 streams.

    Attributes
    ----------
    num_rows, dim: logical matrix shape (rows beyond ``num_rows`` in the last
        chunk are zero padding and are never gathered).
    chunk_rows: rows per chunk; all chunks are padded to this row count so
        device cache slots are shape-stable.
    agg_scale: the per-tensor symmetric int8 scale of the whole matrix —
        bitwise-equal to ``compute_scale_zp(x, symmetric=True).scale``.
    pinned: both representations live in page-locked host memory.
    """

    def __init__(
        self,
        chunks_f32: Sequence[np.ndarray],
        chunks_i8: Sequence[np.ndarray],
        num_rows: int,
        chunk_rows: int,
        agg_scale: np.float32,
        *,
        rows_f32: Optional[np.ndarray] = None,
        rows_i8: Optional[np.ndarray] = None,
        pinned: bool = False,
    ):
        self._f32 = list(chunks_f32)
        self._i8 = list(chunks_i8)
        self.num_rows = int(num_rows)
        self.dim = int(self._f32[0].shape[1]) if self._f32 else 0
        self.chunk_rows = int(chunk_rows)
        self.agg_scale = np.float32(agg_scale)
        self.pinned = bool(pinned)
        # Row-major arrays whose first num_rows rows are the representation
        # (None: concatenated from the chunks on first use).
        self._rows = {"f32": rows_f32, "i8": rows_i8}
        # Tensors over the same memory (the pinned ones a copy must start from).
        self._tensors = {"f32": None, "i8": None}
        self._requant: Tuple[Optional[np.float32], Optional[np.ndarray]] = (None, None)
        self._requant_t: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- factory
    @classmethod
    def from_array(
        cls,
        x: np.ndarray,
        *,
        chunk_rows: int = 4096,
        memmap_dir: Optional[str] = None,
        pin_memory: bool = False,
    ) -> "FeatureStore":
        """Chunk a dense f32 matrix; derive the int8 stream and its scale.

        By default the f32 chunks are zero-copy views of ``x`` (except a
        padded copy of the last chunk) and only the int8 stream allocates
        (¼ of the matrix). With ``memmap_dir`` both streams are written to
        ``features.f32.bin`` / ``features.i8.bin`` memmaps in that directory;
        with ``pin_memory`` both are copied into page-locked memory (needs a
        CUDA build of PyTorch).
        """
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be 2-D, got shape {x.shape}")
        if memmap_dir is not None and pin_memory:
            raise ValueError("pin_memory and memmap_dir are exclusive")
        n, d = x.shape
        r = int(min(max(chunk_rows, 1), max(n, 1)))
        num_chunks = -(-max(n, 1) // r)
        padded_rows = num_chunks * r

        # Chunk-wise symmetric calibration: max is exact, so this equals the
        # dense compute_scale_zp bitwise (padding rows are 0 and cannot raise
        # the amax since amax >= 0).
        amax = np.float32(0.0)
        for lo in range(0, n, r):
            blk = x[lo : lo + r]
            if blk.size:
                amax = np.maximum(amax, np.float32(np.max(np.abs(blk))))
        scale = np.maximum(np.float32(amax / np.float32(_INT8_MAX)), _EPS)

        if memmap_dir is not None:
            os.makedirs(memmap_dir, exist_ok=True)
            f32 = np.memmap(
                os.path.join(memmap_dir, "features.f32.bin"),
                dtype=np.float32, mode="w+", shape=(padded_rows, d),
            )
            i8 = np.memmap(
                os.path.join(memmap_dir, "features.i8.bin"),
                dtype=np.int8, mode="w+", shape=(padded_rows, d),
            )
            f32[:n] = x
            if padded_rows > n:
                f32[n:] = 0.0
        elif pin_memory:
            f32, f32_t = _host_array((padded_rows, d), np.float32, True)
            i8, i8_t = _host_array((padded_rows, d), np.int8, True)
            f32[:n] = x
        else:
            f32 = None
            i8 = np.zeros((padded_rows, d), np.int8)
        chunks_f32 = []
        for lo in range(0, padded_rows, r):
            if f32 is not None:
                blk = f32[lo : lo + r]
            else:
                blk = x[lo : min(lo + r, n)]
                if blk.shape[0] < r:  # pad the ragged last chunk
                    pad = np.zeros((r, d), np.float32)
                    pad[: blk.shape[0]] = blk
                    blk = pad
            chunks_f32.append(blk)
            i8[lo : lo + r] = cls._quantize_block(blk, scale)
        chunks_i8 = [i8[lo : lo + r] for lo in range(0, padded_rows, r)]
        store = cls(chunks_f32, chunks_i8, n, r, scale,
                    rows_f32=x if f32 is None else f32, rows_i8=i8, pinned=pin_memory)
        if pin_memory:
            store._tensors = {"f32": f32_t, "i8": i8_t}
        return store

    @staticmethod
    def _quantize_block(blk: np.ndarray, scale: np.float32) -> np.ndarray:
        """Host mirror of ``quantization.quantize`` (symmetric, zp=0):
        round/clip/cast are all exactly-rounded, so this matches the torch op
        bit for bit."""
        q = np.round(blk / scale)
        return np.clip(q, _INT8_MIN, _INT8_MAX).astype(np.int8)

    # ------------------------------------------------------------ geometry
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.dim)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def num_chunks(self) -> int:
        return len(self._f32)

    @property
    def nbytes(self) -> int:
        """Logical f32 footprint — what the in-memory path would upload."""
        return self.num_rows * self.dim * 4

    @property
    def chunk_bytes_f32(self) -> int:
        return self.chunk_rows * self.dim * 4

    @property
    def chunk_bytes_i8(self) -> int:
        return self.chunk_rows * self.dim

    def chunk_range(self, c: int) -> Tuple[int, int]:
        """Real (unpadded) row span [lo, hi) of chunk ``c``."""
        lo = c * self.chunk_rows
        return lo, min(lo + self.chunk_rows, self.num_rows)

    # -------------------------------------------------------------- access
    def chunk_f32(self, c: int) -> np.ndarray:
        return self._f32[c]

    def chunk_i8(self, c: int) -> np.ndarray:
        return self._i8[c]

    def stream_rows(self, stream: str, scale=None) -> np.ndarray:
        """One representation as a row-major array; its first ``num_rows``
        rows are the matrix's rows, and a padded representation's chunk ``c``
        is rows ``c·chunk_rows`` onward. ``stream`` is ``"f32"`` or ``"i8"``;
        an int8 ``scale`` other than ``agg_scale`` re-quantizes the whole
        matrix under it once (cached for the last such scale), bitwise what
        ``_quantize_block`` gives chunk by chunk (the quantization is
        elementwise). Pinned stores return pinned arrays."""
        if stream not in ("f32", "i8"):
            raise ValueError(f"unknown stream {stream!r}")
        if stream == "i8" and scale is not None and np.float32(scale) != self.agg_scale:
            scale = np.float32(scale)
            if self._requant[0] != scale:
                flat = self.stream_rows("f32")
                out, out_t = _host_array((flat.shape[0], self.dim), np.int8, self.pinned)
                step = self.chunk_rows
                for lo in range(0, flat.shape[0], step):
                    out[lo : lo + step] = self._quantize_block(flat[lo : lo + step], scale)
                self._requant, self._requant_t = (scale, out), out_t
            return self._requant[1]
        if self._rows[stream] is None:
            chunks = self._f32 if stream == "f32" else self._i8
            self._rows[stream] = np.concatenate([np.asarray(c) for c in chunks], axis=0)
        return self._rows[stream]

    def stream_tensor(self, stream: str, scale=None) -> torch.Tensor:
        """``stream_rows`` as a tensor over the same memory: page-locked on a
        pinned store, so a copy from it to the card is a DMA."""
        rows = self.stream_rows(stream, scale)
        if rows is self._requant[1] and self._requant_t is not None:
            return self._requant_t
        t = self._tensors.get(stream)
        if t is not None and rows is self._rows[stream]:
            return t
        return torch.from_numpy(np.asarray(rows))

    def gather_rows_f32(self, row_ids: np.ndarray) -> np.ndarray:
        """Host gather of arbitrary rows (used for the small float-protected
        FTE block); returns a fresh [len(row_ids), dim] f32 array."""
        row_ids = np.asarray(row_ids, np.int64)
        return self.stream_rows("f32")[row_ids]

    def amax_rows(self, row_ids: np.ndarray) -> np.float32:
        """max |x[row_ids]| computed chunk-wise (exact — max never rounds)."""
        row_ids = np.asarray(row_ids, np.int64)
        chunk_of = row_ids // self.chunk_rows
        off = row_ids % self.chunk_rows
        amax = np.float32(0.0)
        for c in np.unique(chunk_of):
            rows = self._f32[c][off[chunk_of == c]]
            if rows.size:
                amax = np.maximum(amax, np.float32(np.max(np.abs(rows))))
        return amax

    def chunk_row_selection(
        self, c: int, row_ids_sorted: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(global positions into ``row_ids_sorted``, local offsets in chunk)
        of the given sorted row ids that fall inside chunk ``c``."""
        lo, hi = c * self.chunk_rows, (c + 1) * self.chunk_rows
        a = np.searchsorted(row_ids_sorted, lo, side="left")
        b = np.searchsorted(row_ids_sorted, hi, side="left")
        sel = row_ids_sorted[a:b]
        return np.arange(a, b, dtype=np.int64), sel - lo

    def dense(self) -> np.ndarray:
        """Materialize the full f32 matrix (budget-violating fallback path —
        callers count it so it is loud in telemetry)."""
        out = np.empty((self.num_rows, self.dim), np.float32)
        for c in range(self.num_chunks):
            lo, hi = self.chunk_range(c)
            out[lo:hi] = self._f32[c][: hi - lo]
        return out
