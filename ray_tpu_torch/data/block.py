"""Block model: the unit of distributed data (a copy of
``ray_tpu/data/block.py``; pyarrow stays a lazy import, so nothing on a
numeric path needs it; rows whose sequences differ in length make an
object column, where ``ray_tpu``'s ``normalize`` raises).

Parity target: reference python/ray/data/block.py (BlockAccessor :57-66).
The reference's blocks are Arrow or pandas tables; here the native block
format is a **column dict** — numeric columns are numpy arrays (the
zero-copy format of the shm object store and the direct input to
`iter_batches(device_put=...)`), while string/binary/nested/nullable
columns may be **pyarrow Arrays** (the reference's Arrow block path,
block.py:57): they pickle protocol-5 out-of-band, so Arrow buffers ride
the shm store zero-copy exactly like numpy, and string-keyed groupby/sort
never materializes numpy object arrays. The `col_*` helpers below are the
dispatch layer every column-level operation routes through.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Block = Dict[str, Any]  # column name -> numpy [n, ...] or pyarrow Array


def is_arrow_col(col: Any) -> bool:
    t = type(col)
    return t.__module__.startswith("pyarrow") and hasattr(col, "type")


def _as_single_chunk(col):
    """ChunkedArray -> Array (slicing/take on one chunk is zero-copy)."""
    if hasattr(col, "combine_chunks"):
        return col.combine_chunks()
    return col


def col_len(col: Any) -> int:
    return len(col)


def col_slice(col: Any, start: int, end: int):
    if is_arrow_col(col):
        return col.slice(start, max(0, end - start))
    return col[start:end]


def col_take(col: Any, idx: np.ndarray):
    """Row gather by int positions (exchange partitioning, shuffles,
    group extraction)."""
    if is_arrow_col(col):
        return _as_single_chunk(col).take(np.asarray(idx, np.int64))
    return col[idx]


def col_concat(cols: Sequence[Any]):
    if any(is_arrow_col(c) for c in cols):
        import pyarrow as pa

        chunks = []
        for c in cols:
            if is_arrow_col(c):
                chunks.extend(c.chunks if hasattr(c, "chunks") else [c])
            else:
                chunks.append(pa.array(c))
        return pa.chunked_array(chunks).combine_chunks()
    return np.concatenate(list(cols))


def rows_view(block: Block) -> Dict[str, Any]:
    """Row-iterable view: arrow columns -> python lists, numpy columns
    pass through (the one place row materialization lives — every row
    sink and iter_rows routes here)."""
    return {k: (v.to_pylist() if is_arrow_col(v) else v)
            for k, v in block.items()}


def col_tolist(col: Any) -> list:
    if is_arrow_col(col):
        return col.to_pylist()
    return col.tolist()


def col_sort_indices(col: Any, descending: bool = False) -> np.ndarray:
    if is_arrow_col(col):
        import pyarrow.compute as pc

        order = "descending" if descending else "ascending"
        return np.asarray(pc.sort_indices(
            col, sort_keys=[("", order)]), np.int64)
    order = np.argsort(col, kind="stable")
    return order[::-1] if descending else order


def col_sorted_sample(col: Any, k: int):
    """Up to k evenly-spaced values in sorted order (sort sampling).
    Returns a numpy array for numeric columns, a python list otherwise
    (boundary comparisons happen element-wise either way)."""
    n = col_len(col)
    if is_arrow_col(col):
        import pyarrow.compute as pc

        nn = pc.drop_null(_as_single_chunk(col))
        if len(nn) <= k:
            return sorted(nn.to_pylist())
        # Sample k positions first, sort only the sample (the numpy
        # branch's O(k log k) contract — never a full column sort).
        idx = np.linspace(0, len(nn) - 1, k).astype(np.int64)
        return sorted(nn.take(idx).to_pylist())
    if n <= k:
        return np.sort(col)
    idx = np.linspace(0, n - 1, k).astype(np.int64)
    return np.sort(col[idx])


def col_unique_inverse(col: Any) -> Tuple[Any, np.ndarray]:
    """(unique values, [n] int inverse mapping) — the group-by kernel.
    Arrow columns dictionary-encode (no object arrays); uniques keep the
    column's representation."""
    if is_arrow_col(col):
        import pyarrow as pa
        import pyarrow.compute as pc

        enc = _as_single_chunk(col).dictionary_encode()
        uniq = enc.dictionary
        # dictionary order is first-appearance; normalize to sorted so
        # merged partitions agree with the numpy np.unique contract.
        order = np.asarray(pc.sort_indices(uniq), np.int64)
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        if enc.indices.null_count:
            # Null keys form one trailing group of their own.
            raw = np.asarray(pc.fill_null(enc.indices, -1), np.int64)
            inverse = np.where(raw >= 0, rank[raw], len(order))
            uniq_out = pa.concat_arrays(
                [uniq.take(order).cast(uniq.type),
                 pa.nulls(1, uniq.type)])
            return uniq_out, inverse
        inverse = np.asarray(enc.indices, np.int64)
        return uniq.take(order), rank[inverse]
    return np.unique(col, return_inverse=True)


def _rows_column(values) -> np.ndarray:
    """One column of a list of rows. Sequences of different lengths (the
    token ids of prompts of different lengths) make an object column, one
    sequence a row, where ``ray_tpu``'s ``np.asarray`` raises."""
    try:
        return np.asarray(values)
    except ValueError:
        col = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            col[i] = v
        return col


class BlockAccessor:
    """Uniform view over a block (column dict)."""

    def __init__(self, block: Block):
        if not isinstance(block, dict):
            raise TypeError(f"block must be a column dict, got {type(block)}")
        self._b = block

    @staticmethod
    def normalize(data: Any) -> Block:
        """Accept a column dict, a list of row dicts, a list of scalars, or
        a numpy array; return the canonical column-dict block. Pyarrow
        columns pass through unconverted (the Arrow path)."""
        if isinstance(data, dict):
            return {k: (_as_single_chunk(v) if is_arrow_col(v)
                        else np.asarray(v))
                    for k, v in data.items()}
        if isinstance(data, np.ndarray):
            return {"data": data}
        if isinstance(data, (list, tuple)):
            if not data:
                return {}
            if isinstance(data[0], dict):
                cols = {k: [] for k in data[0]}
                for row in data:
                    if row.keys() != cols.keys():
                        raise ValueError(
                            f"inconsistent row keys: {sorted(row)} vs "
                            f"{sorted(cols)}")
                    for k, v in row.items():
                        cols[k].append(v)
                return {k: _rows_column(v) for k, v in cols.items()}
            return {"item": _rows_column(data)}
        raise TypeError(f"cannot make a block from {type(data)}")

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        return sum(v.nbytes if hasattr(v, "nbytes") else 0
                   for v in self._b.values())

    def schema(self) -> Dict[str, Any]:
        return {k: ((v.type, ()) if is_arrow_col(v)
                    else (v.dtype, v.shape[1:]))
                for k, v in self._b.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: col_slice(v, start, end) for k, v in self._b.items()}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        n = self.num_rows()
        keys = list(self._b)
        cols = rows_view(self._b)
        for i in range(n):
            yield {k: cols[k][i] for k in keys}

    def to_batch(self) -> Block:
        return self._b

    @staticmethod
    def concat(blocks: Sequence[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return {}
        keys = blocks[0].keys()
        for b in blocks:
            if b.keys() != keys:
                raise ValueError("cannot concat blocks with different columns")
        return {k: col_concat([b[k] for b in blocks]) for k in keys}


class BlockMetadata:
    """Driver-side facts about a block (the block itself stays in the
    object store; reference keeps metadata on the driver the same way)."""

    __slots__ = ("num_rows", "size_bytes", "input_files")

    def __init__(self, num_rows: int, size_bytes: int,
                 input_files: Optional[List[str]] = None):
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.input_files = input_files or []

    @staticmethod
    def of(block: Block, files: Optional[List[str]] = None) -> "BlockMetadata":
        acc = BlockAccessor(block)
        return BlockMetadata(acc.num_rows(), acc.size_bytes(), files)
