"""Chunk-based tensor representation (paper §2.1, §3.1).

A matrix ``W ∈ R^{m×n}`` is stored as a relational table with rows

    (row_id, chunk_id, chunk FLOAT[chunk_size])

where each original row is split into ``ceil(n / chunk_size)`` contiguous
vector chunks.  The table is realised as a dense tensor of shape
``[m, n_chunks, chunk_size]`` on an explicit device — a columnar table over
a *dense* integer key domain, where the key (row_id, chunk_id) is simply the
address.  Non-divisor chunk sizes zero-pad the last chunk; the padding
invariants are enforced by the schema
(``true_cols ≤ n_chunks·chunk_size < true_cols + chunk_size``) so the
true width can always be recovered exactly.

Higher-rank tensors keep their leading dimensions as additional key columns
(the paper: "each dimension is broken into one or more chunk indices").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

DEFAULT_CHUNK_SIZE = 128


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    CUDA raises instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class ChunkedSchema:
    """Relational schema of a chunked tensor table.

    ``key_cols``: ordered (name, domain_size) pairs — e.g. (("row_id", m),
    ("chunk_id", n_chunks)).  ``vec_col`` names the FLOAT[chunk] payload.
    ``true_cols`` is the unpadded length of the chunked dimension, so the
    padding can be stripped.
    """

    name: str
    key_cols: Tuple[Tuple[str, int], ...]
    vec_col: str
    chunk_size: int
    true_cols: int

    def __post_init__(self):
        # padding invariants: the chunk grid covers the true width with
        # strictly less than one chunk of padding, so the tail can be
        # stripped exactly and byte accounting knows the physical size
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive: {self}")
        padded = self.n_chunks * self.chunk_size
        if not (self.true_cols <= padded < self.true_cols + self.chunk_size):
            raise ValueError(
                f"inconsistent chunking for {self.name!r}: {self.n_chunks} "
                f"chunks of {self.chunk_size} cannot represent "
                f"{self.true_cols} columns")

    @property
    def n_chunks(self) -> int:
        return self.key_cols[-1][1]

    @property
    def key_names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.key_cols)

    @property
    def padded_cols(self) -> int:
        """Physical width of the chunked dimension (incl. zero padding)."""
        return self.n_chunks * self.chunk_size

    @property
    def pad(self) -> int:
        """Zero elements in the last chunk (0 for divisor chunk sizes)."""
        return self.padded_cols - self.true_cols

    def ddl(self, dtype: str = "FLOAT") -> str:
        """CREATE TABLE statement for this schema (Appendix A style)."""
        cols = ", ".join(f"{k} INT32" for k, _ in self.key_cols)
        return (
            f"CREATE TABLE {self.name} ({cols}, "
            f"{self.vec_col} {dtype}[{self.chunk_size}]);"
        )


@dataclasses.dataclass
class ChunkedTensor:
    """A tensor in the chunk-based table layout.

    ``data`` has shape ``[*key_sizes, chunk_size]`` where the last key is the
    chunk index.  The logical table rows are all index tuples of ``data``'s
    leading axes.
    """

    schema: ChunkedSchema
    data: torch.Tensor  # [*key_dims, chunk_size]

    @property
    def chunk_size(self) -> int:
        return self.schema.chunk_size

    @staticmethod
    def n_chunks_for(cols: int, chunk_size: int) -> int:
        return max(1, math.ceil(cols / chunk_size))

    @classmethod
    def from_dense(
        cls,
        name: str,
        array,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        key_names: Sequence[str] | None = None,
        *,
        device,
    ) -> "ChunkedTensor":
        """Chunk the trailing dimension of ``array`` (numpy or torch) into
        FLOAT[chunk] rows of a tensor on ``device``.  A divisor chunk size
        on a tensor already there is a zero-copy view."""
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        array = torch.as_tensor(array).to(device)
        if array.ndim == 0:
            raise ValueError("cannot chunk a scalar; store as constant")
        *lead, cols = array.shape
        n_chunks = cls.n_chunks_for(cols, chunk_size)
        pad = n_chunks * chunk_size - cols
        if pad:
            array = torch.nn.functional.pad(array, (0, pad))
        data = array.reshape(*lead, n_chunks, chunk_size)
        if key_names is None:
            base = ["row_id", "col_id", "head_id", "pos_id"]
            key_names = base[: len(lead)] if len(lead) <= len(base) else [
                f"k{i}" for i in range(len(lead))
            ]
        key_cols = tuple(zip(tuple(key_names), tuple(lead))) + (
            ("chunk_id", n_chunks),
        )
        schema = ChunkedSchema(
            name=name,
            key_cols=key_cols,
            vec_col="chunk",
            chunk_size=chunk_size,
            true_cols=cols,
        )
        return cls(schema=schema, data=data)

