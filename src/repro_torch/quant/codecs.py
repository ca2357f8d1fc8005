"""Quantised chunk-payload codecs (ISSUE 5 tentpole, ROADMAP "Quantised
chunk payloads").

A chunked weight table ``W(keys..., chunk FLOAT[cs])`` stores 4 bytes per
element; on the low-resource hardware the paper targets, bytes-per-weight
is the dominant term for cold-cache prefill (the whole table streams
through the pager working set).  A *quantised* chunk table stores integer
codes plus one scale per chunk group instead:

    W__int8(keys..., qchunk INT8[cs],  scale FLOAT)   — absmax / 127
    W__nf4 (keys..., qchunk UINT4[cs], scale FLOAT)   — NF4 codebook

and the matmul projection dequantises inline (``qchunk * scale`` /
``nf4_dequant(qchunk) * scale``) — everything stays pure SQL, exactly the
paper's dequantise-in-the-projection idiom.  The quantisation *group* is
the chunk vector itself, so the relational encoding is uniform: one extra
scalar column, no auxiliary tables, and the group size is the planner's
chunk size (a second use of the same physical-design axis).

Codecs
------
``int8`` — absmax-per-chunk-group linear quantisation: ``scale =
max|x| / 127``, ``q = round(x / scale) ∈ [-127, 127]``.  Round-trip error
is bounded by ``scale / 2`` per element.

``nf4`` — 4-bit NormalFloat block quantisation (the QLoRA codebook):
``scale = max|x|``, each normalised value ``x / scale ∈ [-1, 1]`` maps to
the nearest of 16 fixed levels (quantiles of a standard normal, which is
exactly how ``init_llama_params``-style weights are distributed).
Round-trip error is bounded by ``scale · max_half_gap`` per element
(``max_half_gap`` ≈ 0.152, half the widest gap between adjacent levels).

Both codecs ship plain PyTorch quantise/dequantise functions (the
executor path; their codes are bit-identical to the reference package's:
the same f32 operations in the same order, ``torch.round`` rounding half
to even, and NF4's midpoint count taken by ``torch.bucketize``), the
packing used by the cold store (NF4 packs two codes per byte so
pager byte accounting matches the 0.5 B/element format), and the error
bounds the property tests and the engine's accuracy-budget gate consume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import relational as ra
from repro_torch.core.executor import DenseTable
from repro_torch.core.relational import RelSchema, call, col, mul

# Numerical floor for group scales: an all-zero chunk group quantises to
# all-zero codes with a harmless tiny scale instead of dividing by zero.
SCALE_EPS = 1e-12

# The QLoRA NF4 codebook: 16 quantiles of N(0, 1) normalised to [-1, 1].
NF4_LEVELS: Tuple[float, ...] = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
# decision boundaries: midpoints between adjacent levels — an encode is
# "count the midpoints strictly below the value", which the SQL
# ``nf4_encode`` macro reproduces with the same ``>`` comparisons
NF4_MIDPOINTS: Tuple[float, ...] = tuple(
    (NF4_LEVELS[i] + NF4_LEVELS[i + 1]) / 2.0 for i in range(15))
# worst-case |x/scale - level| once rounded to the nearest level
NF4_MAX_HALF_GAP: float = max(
    NF4_LEVELS[i + 1] - NF4_LEVELS[i] for i in range(15)) / 2.0

_NF4_LEVELS_ARR = torch.tensor(NF4_LEVELS, dtype=torch.float32)
_NF4_MIDPOINTS_ARR = torch.tensor(NF4_MIDPOINTS, dtype=torch.float32)
_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _table_on(arr: torch.Tensor, device) -> torch.Tensor:
    """``arr`` on ``device``, copied there once per device."""
    k = (id(arr), str(device))
    if k not in _ON_DEVICE:
        _ON_DEVICE[k] = arr.to(device)
    return _ON_DEVICE[k]


def _as_tensor(a, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def nf4_dequant_levels(codes) -> torch.Tensor:
    """Codebook lookup: NF4 codes ∈ [0, 16) → normalised levels ∈ [-1, 1].

    The executor's ``nf4_dequant`` intrinsic (SQL: the ``nf4_dequant``
    macro / UDF)."""
    codes = _as_tensor(codes)
    return _table_on(_NF4_LEVELS_ARR, codes.device)[codes.long()]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One quantised chunk-payload format.

    ``code_bytes`` is the *stored* payload bytes per element (0.5 for the
    packed NF4 format); ``dequant_multiplier`` scales the planner's
    per-element dequant compute term (``CostParams.dequant_weight``) —
    the codebook lookup costs more than a multiply; ``error_frac`` bounds
    the per-element round-trip error as a fraction of the group scale;
    ``sql_code_type`` is the DDL payload dtype of the code column.
    """

    name: str
    bits: int
    code_bytes: float
    sql_code_type: str
    dequant_multiplier: float
    error_frac: float

    # -- reference kernels --------------------------------------------------

    def quantise(self, data) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[..., cs] f32 → (codes int8 [..., cs], scales f32 [...])``.

        The quantisation group is the trailing (chunk-vector) axis.  Runs
        on ``data``'s device."""
        data = _as_tensor(data, torch.float32)
        absmax = torch.clamp(data.abs().amax(dim=-1), min=SCALE_EPS)
        if self.name == "int8":
            # a tensor divisor: on the card, PyTorch divides by a Python
            # number as a multiply by its reciprocal, which is not the
            # reference's IEEE quotient and flips about one code in 1500
            scales = absmax / absmax.new_full((), 127.0)
            codes = torch.clamp(torch.round(data / scales[..., None]),
                                -127, 127).to(torch.int8)
        elif self.name == "nf4":
            scales = absmax
            v = data / scales[..., None]
            # the count of midpoints strictly below v (the reference's
            # sum(v > midpoints)) without a [..., cs, 15] temporary
            codes = torch.bucketize(
                v, _table_on(_NF4_MIDPOINTS_ARR, v.device)).to(torch.int8)
        else:  # pragma: no cover - registry guards this
            raise ValueError(self.name)
        return codes, scales

    def dequantise(self, codes, scales) -> torch.Tensor:
        """Inverse function: ``(codes, scales) → f32 [..., cs]``."""
        codes = _as_tensor(codes)
        scales = _as_tensor(scales, torch.float32)
        if self.name == "int8":
            return codes.to(torch.float32) * scales[..., None]
        return nf4_dequant_levels(codes) * scales[..., None]

    # -- error bounds -------------------------------------------------------

    def roundtrip_bound(self, scales) -> torch.Tensor:
        """Per-element bound on ``|x - dequantise(quantise(x))|`` for each
        group, as a function of the group scales."""
        return _as_tensor(scales, torch.float32) * self.error_frac

    def matmul_bound(self, scales, x_abs) -> np.ndarray:
        """Bound on the output error of ``x · dequant(W)ᵀ`` vs ``x · Wᵀ``.

        ``scales``: group scales of the row-chunked weight ``[*row, nch]``;
        ``x_abs``: the activation's |x| chunked the same way ``[T, nch,
        cs]``.  Each output element's error is at most
        ``Σ_c bound[row, c] · Σ_i |x[t, c, i]|``.
        """
        per_chunk = self.roundtrip_bound(scales).cpu().numpy()  # [*row, nch]
        x_l1 = np.abs(_as_tensor(x_abs).cpu().numpy()).sum(axis=-1)  # [T, nch]
        lead = per_chunk.shape[:-1]
        return np.einsum("tc,rc->tr", x_l1,
                         per_chunk.reshape(-1, per_chunk.shape[-1])
                         ).reshape(x_l1.shape[0], *lead)

    # -- relational encoding ------------------------------------------------

    def dequant_expr(self, q_col: str = "qchunk",
                     scale_col: str = "scale") -> ra.Expr:
        """The inline dequant projection body: vec[cs] expression over the
        quantised table's columns (rendered by sqlgen in both dialects,
        evaluated by the executor)."""
        if self.name == "int8":
            return mul(col(q_col), col(scale_col))
        return mul(call("nf4_dequant", col(q_col)), col(scale_col))

    # -- cold-store packing -------------------------------------------------

    def pack(self, codes: np.ndarray) -> np.ndarray:
        """Codes → the stored byte layout (pager cold tier / disk).

        NF4 packs two 4-bit codes per byte along the trailing axis (odd
        chunk widths keep a zero nibble tail); INT8 is stored as-is."""
        codes = (codes.cpu().numpy() if isinstance(codes, torch.Tensor)
                 else np.asarray(codes))
        if self.name == "int8":
            return codes.astype(np.int8)
        u = codes.astype(np.uint8)
        if u.shape[-1] % 2:
            u = np.concatenate(
                [u, np.zeros(u.shape[:-1] + (1,), np.uint8)], axis=-1)
        lo, hi = u[..., 0::2], u[..., 1::2]
        return (lo | (hi << 4)).astype(np.uint8)

    def unpack(self, stored, chunk_size: int) -> torch.Tensor:
        """Inverse of :meth:`pack` (on the stored bytes' device): stored
        bytes → int8 codes ``[..., chunk_size]``."""
        stored = _as_tensor(stored)
        if self.name == "int8":
            return stored.to(torch.int8)
        lo = (stored & 0xF).to(torch.int8)
        hi = ((stored >> 4) & 0xF).to(torch.int8)
        codes = torch.stack([lo, hi], dim=-1).reshape(
            *stored.shape[:-1], 2 * stored.shape[-1])
        return codes[..., :chunk_size]

    # -- byte model ---------------------------------------------------------

    def table_bytes(self, n_elements: int, n_groups: int) -> int:
        """Stored bytes of a quantised chunk table: packed payload plus one
        f32 scale per group."""
        return int(math.ceil(n_elements * self.code_bytes)) + 4 * n_groups


CODECS: Dict[str, Codec] = {
    # int8: rounding moves at most half a code step, so |Δ| ≤ scale · 0.5
    "int8": Codec(name="int8", bits=8, code_bytes=1.0,
                  sql_code_type="TINYINT", dequant_multiplier=1.0,
                  error_frac=0.5),
    "nf4": Codec(name="nf4", bits=4, code_bytes=0.5,
                 sql_code_type="UTINYINT", dequant_multiplier=2.0,
                 error_frac=NF4_MAX_HALF_GAP),
}

#: Precisions the planner prices: the f32 baseline plus every codec.
PRECISIONS: Tuple[str, ...] = ("f32",) + tuple(CODECS)

F32_BYTES_PER_ELEMENT = 4


def precision_bytes(precision: str, n_elements: int, n_groups: int) -> int:
    """Stored bytes of one weight table at ``precision`` (incl. scales)."""
    if precision == "f32":
        return F32_BYTES_PER_ELEMENT * n_elements
    return CODECS[precision].table_bytes(n_elements, n_groups)


def q_table_name(table: str, precision: str) -> str:
    return f"{table}__{precision}"


def quant_schema(src_schema: RelSchema, q_col: str = "qchunk",
                 scale_col: str = "scale") -> RelSchema:
    """Relational schema of the quantised twin of a chunked weight table:
    same keys, the vec payload becomes integer codes plus a per-group
    (per-row) scale column."""
    (vec_col, vec_type), = src_schema.cols
    assert ra.is_vec(vec_type), src_schema
    return RelSchema(keys=src_schema.keys,
                     cols=((q_col, vec_type), (scale_col, ra.SCALAR)))


def quantise_chunked_table(table: DenseTable, codec: Codec,
                           q_col: str = "qchunk",
                           scale_col: str = "scale") -> DenseTable:
    """Quantise a resident chunked DenseTable (executor-side conversion —
    the SQL side is ``repro_torch.quant.sql.quantise_conversion_sql``), on
    the table's device."""
    if len(table.cols) != 1:
        raise ValueError("quantise expects a single-vector-column table")
    vec_col, arr = next(iter(table.cols.items()))
    if not ra.is_vec(table.col_types[vec_col]):
        raise ValueError(f"column {vec_col} is not a vector column")
    codes, scales = codec.quantise(arr)
    return DenseTable(
        keys=table.keys,
        cols={q_col: codes, scale_col: scales},
        col_types={q_col: table.col_types[vec_col], scale_col: ra.SCALAR},
    )


def quantise_dense(arr, chunk_size: int, codec: Codec
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantise a dense weight array grouped at ``chunk_size`` along the
    trailing dim (zero-padding the tail): ``(packed_codes, scales)`` in the
    cold-store layout as host arrays — the paged engine's offline
    conversion.  Runs on the device of a tensor (a numpy array on the
    CPU)."""
    arr = _as_tensor(arr, torch.float32)
    *lead, width = arr.shape
    nch = max(1, -(-width // chunk_size))
    pad = nch * chunk_size - width
    if pad:
        arr = torch.nn.functional.pad(arr, (0, pad))
    grouped = arr.reshape(*lead, nch, chunk_size)
    codes, scales = codec.quantise(grouped)
    return codec.pack(codes), scales.cpu().numpy()
