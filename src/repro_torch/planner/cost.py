"""Cost model for physical-layout selection (rows scanned + join fan-out).

The unit of cost is "relational rows touched": every physical operator in
the columnar engine (and in DuckDB) does work proportional to the number of
rows it scans, emits, or groups.  For a matmul ``X[T, n] · Wᵀ[n, m]`` with
input chunk size ``cs`` (ROW_CHUNK) / output chunk size ``cs'``
(COL_CHUNK):

  ROW_CHUNK   scan W          m · n/cs
              scan X          T · n/cs
              join output     T · n/cs · m      (each X chunk meets m rows)
              agg groups      T · m             (reduction key j explodes
                                                 into the GROUP BY)
              re-chunk tail   2 · T · m         (π key-split + collect)

  COL_CHUNK   scan W__col     n · m/cs'
              unnest X        T · n             (chunk → scalar rows)
              join output     T · n · m/cs'     (each scalar row meets m/cs'
                                                 rows)
              agg groups      T · m/cs'         (groups BY output chunk —
                                                 already chunked, no tail)

Join fan-out (rows emitted by the join) is identical up to chunking
(``T·n·m/cs``), so the decision is driven by the GROUP BY cardinality and
the re-chunk tail that ROW_CHUNK pays versus the UNNEST that COL_CHUNK
pays.  Both are parameterised by the seq-len ``T`` and the chunk sizes, so
prefill (large T) and decode (T = 1) pipelines price the same weight table
independently and may pick different layouts.

Per-head projections (``map_linear_heads``, total output m = H · dh) price
identically with the head key as a block dimension: COL_CHUNK_HEADS is the
column cost with ``m = H · dh`` output features chunked per head
(:func:`colh_chunk_cost`).

Cache layouts price the *decode attention* access pattern instead of a
matmul: every layout scans the same ``S · H_kv · n_chunks`` cache rows per
join, so the decision is driven by *locality* — the number of contiguous
row segments the history scans and the INSERT of the new tokens touch
(:func:`cache_layout_cost`), weighted by ``CostParams.seek_weight``.  The
INSERT term scales with the tokens appended per invocation, so
append-dominated (prefill-heavy) pricing can rank ``pos_major`` first
while decode-dominated pricing keeps ``head_major`` — the measured split
in ``BENCH_attn_layout.json``.

Batch size is a pricing input, not a special case: a batched decode
pipeline's activation tables carry the ``seq`` key, so every matmul
site's ``seq_len`` (the product of its non-head base keys) is the batch
size B and the matmul terms scale accordingly; cache sites carry
``batch`` explicitly and multiply their per-sequence locality terms by
it.  Column-layout benefit per byte therefore *grows* with B — the
weight scan amortises over the whole batch — which is why the planner
re-prices (rather than reuses) layouts for batched plans.

Chunk size as a degree of freedom
---------------------------------
The paper picks ``chunk_size`` by a brute-force sweep (Tab. 1); here it is
a *priced* planner decision.  A weight table may be stored at a physical
chunk size different from the pipeline's activation chunking:

  ROW_CHUNK at ``cs_w ≠ cs``  — the activation must be re-chunked to
      ``cs_w`` before the join (UNNEST + key merge/split + collect):
      ``T·n`` unnested rows plus ``T·⌈n/cs_w⌉`` collect groups.
  COL_CHUNK at ``cs' ≠ cs_out`` — the already-chunked output must be
      re-chunked back to the consumer chunking (same adapter shape over
      the ``T·m`` output elements).

:func:`row_chunk_cost` / :func:`col_chunk_cost` take the adapter into
account via their ``act_chunk`` / ``out_chunk`` keywords; the candidate
set is ``CHUNK_CANDIDATES`` filtered to divisors of the chunked dimension
(:func:`divisor_candidates` — divisors keep the physical tables pad-free,
so a column copy's residency bytes equal the logical weight bytes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, TYPE_CHECKING

from repro_torch.planner.layout import (
    CACHE_HEAD_MAJOR, CACHE_POS_MAJOR, CACHE_ROW_CHUNK, COL_CHUNK,
    COL_CHUNK_HEADS, ROW_CHUNK, divisor_candidates,
)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.planner.layout import CacheSite, MatmulSite

# Candidate physical chunk sizes the planner prices jointly with layout
# (the paper's Tab. 1 sweep grid).  Sites additionally admit their seed
# chunk size, so tiny test models degrade gracefully.
CHUNK_CANDIDATES: Tuple[int, ...] = (32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Knobs the planner prices a pipeline under."""

    seq_len: int = 1          # T: new tokens per pipeline invocation
    group_weight: float = 1.0  # relative cost of producing one GROUP BY group
    row_weight: float = 1.0    # relative cost of touching one row
    seek_weight: float = 4.0   # relative cost of starting a new contiguous
    #                            row segment (cache-layout locality term)
    # -- precision pricing (quantised chunk payloads) ----------------------
    # byte_weight prices one byte of a weight table streamed through the
    # working set per invocation; dequant_weight prices dequantising one
    # element in the projection (scaled by the codec's multiplier).  The
    # analytic defaults keep f32 preferred when memory is unconstrained
    # (4·bw < bw·bpe + dq for both codecs) — quantisation wins on byte
    # pressure (the residency budget pass) or once calibration measures
    # bytes as expensive relative to dequant compute (cold-cache regimes).
    byte_weight: float = 1.0 / 16.0
    dequant_weight: float = 0.25


@dataclasses.dataclass(frozen=True)
class MatmulCost:
    """Row-level cost breakdown of one matmul under one layout."""

    layout: str
    scan_rows: int      # weight + activation base-table rows
    join_rows: int      # rows emitted by the join (fan-out)
    agg_groups: int     # GROUP BY output cardinality
    aux_rows: int       # re-chunk tail (row) / unnest (col) rows
    chunk_size: int = 0     # physical chunk of the priced weight table
    rechunk_rows: int = 0   # chunk-size adapter: rows unnested
    rechunk_groups: int = 0  # chunk-size adapter: collect groups

    def total(self, params: CostParams) -> float:
        rows = (self.scan_rows + self.join_rows + self.aux_rows
                + self.rechunk_rows)
        return (params.row_weight * rows
                + params.group_weight * (self.agg_groups
                                         + self.rechunk_groups))


def row_chunk_cost(T: int, in_f: int, out_f: int, cs: int,
                   act_chunk: Optional[int] = None) -> MatmulCost:
    """ROW_CHUNK cost with the weight table stored at chunk ``cs``.

    ``act_chunk`` is the pipeline's activation chunking; when it differs
    from ``cs`` the activation pays a re-chunk adapter before the join.
    """
    n_chunks = max(1, math.ceil(in_f / cs))
    rechunk = act_chunk is not None and act_chunk != cs
    return MatmulCost(
        layout=ROW_CHUNK,
        scan_rows=out_f * n_chunks + T * n_chunks,
        join_rows=T * n_chunks * out_f,
        agg_groups=T * out_f,
        aux_rows=2 * T * out_f,
        chunk_size=cs,
        rechunk_rows=T * in_f if rechunk else 0,
        rechunk_groups=T * n_chunks if rechunk else 0,
    )


def col_chunk_cost(T: int, in_f: int, out_f: int, cs_out: int,
                   out_chunk: Optional[int] = None) -> MatmulCost:
    """COL_CHUNK cost with the transposed table chunked at ``cs_out``.

    ``out_chunk`` is the chunking downstream consumers expect; when it
    differs from ``cs_out`` the already-chunked output pays a re-chunk
    tail back to the consumer chunking.
    """
    n_out_chunks = max(1, math.ceil(out_f / cs_out))
    rechunk = out_chunk is not None and out_chunk != cs_out
    return MatmulCost(
        layout=COL_CHUNK,
        scan_rows=in_f * n_out_chunks + T * in_f,
        join_rows=T * in_f * n_out_chunks,
        agg_groups=T * n_out_chunks,
        aux_rows=T * in_f,  # UNNEST of the activation chunks
        chunk_size=cs_out,
        rechunk_rows=T * out_f if rechunk else 0,
        rechunk_groups=(T * max(1, math.ceil(out_f / out_chunk))
                        if rechunk else 0),
    )


def colh_chunk_cost(T: int, n_heads: int, in_f: int, head_dim: int,
                    cs_out: int, out_chunk: Optional[int] = None
                    ) -> MatmulCost:
    """Head-blocked column cost: the head key is a pure block dimension, so
    the shape is the plain column cost over ``m = H · dh`` total output
    features chunked per head (H · dh/cs' output chunks)."""
    c = col_chunk_cost(T, in_f, n_heads * head_dim, cs_out,
                       out_chunk=out_chunk)
    return dataclasses.replace(c, layout=COL_CHUNK_HEADS)


def site_costs(site: "MatmulSite", params: CostParams):
    """(row_cost, col_cost) totals for a matched matmul site.

    For head sites the column cost is the head-blocked COL_CHUNK_HEADS
    variant; the row cost prices the full ``H · dh`` output either way.
    """
    T = params.seq_len
    out_total = site.n_heads * site.out_features
    row = row_chunk_cost(T, site.in_features, out_total, site.row_chunk)
    if site.is_head_site:
        col = colh_chunk_cost(T, site.n_heads, site.in_features,
                              site.out_features, site.col_chunk)
    else:
        col = col_chunk_cost(T, site.in_features, out_total, site.col_chunk)
    return row.total(params), col.total(params)


def site_chunk_costs(site: "MatmulSite", params: CostParams,
                     candidates=()):
    """Joint (layout, chunk_size) pricing for a matched matmul site.

    Returns ``(row_costs, col_costs)`` — two ``{chunk_size: MatmulCost}``
    dicts over the admissible candidate sizes (divisors of the chunked
    dimension, always including the seed sizes).  Non-seed sizes carry
    the re-chunk adapter terms.
    """
    T = params.seq_len
    out_total = site.n_heads * site.out_features
    row_costs = {
        cs: row_chunk_cost(T, site.in_features, out_total, cs,
                           act_chunk=site.row_chunk)
        for cs in site.row_chunk_candidates(candidates)
    }
    col_costs = {}
    for cs in site.col_chunk_candidates(candidates):
        if site.is_head_site:
            c = colh_chunk_cost(T, site.n_heads, site.in_features,
                                site.out_features, cs,
                                out_chunk=site.col_chunk)
        else:
            c = col_chunk_cost(T, site.in_features, out_total, cs,
                               out_chunk=site.col_chunk)
        col_costs[cs] = c
    return row_costs, col_costs


def best_chunk(costs, params: CostParams, seed: int):
    """(chunk_size, total) minimising ``costs``; ties prefer the seed size,
    then the smaller candidate (deterministic plans)."""
    return min(((cs, c.total(params)) for cs, c in costs.items()),
               key=lambda kv: (kv[1], kv[0] != seed, kv[0]))


def choose_layout(site: "MatmulSite", params: Optional[CostParams] = None
                  ) -> str:
    """Cost-based layout choice for one matmul site."""
    params = params or CostParams()
    row, col = site_costs(site, params)
    return site.col_layout if col < row else ROW_CHUNK


# ---------------------------------------------------------------------------
# Cache layouts — decode-attention locality model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheCost:
    """Locality breakdown of one decode step against one cache layout.

    ``scan_rows`` is layout-invariant (both attention joins touch every
    cached row); ``read_segments`` counts the contiguous runs the per-head
    history scans start, ``write_segments`` the runs the INSERT of the new
    token's rows starts.  Seeks are what the layout moves.
    """

    layout: str
    scan_rows: int
    read_segments: int
    write_segments: int

    def total(self, params: CostParams) -> float:
        return (params.row_weight * self.scan_rows
                + params.seek_weight * (self.read_segments
                                        + self.write_segments))


def cache_layout_cost(layout: str, cache_len: int, n_heads: int,
                      n_chunks: int, new_tokens: int = 1,
                      batch: int = 1) -> CacheCost:
    """Price one pipeline invocation (``new_tokens`` appended, then two
    attention joins scanning all ``cache_len`` positions).

    Contiguous-run lengths per layout (keys in physical order):

      row_chunk  (tp, hk, c): per-head read runs of ``n_chunks`` (one
                 position's chunks) → S runs/head; append writes one
                 contiguous ``H·n_chunks`` block per token.
      head_major (hk, tp, c): per-head history is one run of
                 ``S·n_chunks`` → 1 run/head; append scatters one
                 ``n_chunks`` run per head per token.
      pos_major  (tp, c, hk): heads are innermost — the attention joins'
                 head-group gather sweeps every head of one (position,
                 chunk) in a single contiguous run → ``S·n_chunks`` runs
                 per join (*not* per head: the vectorised scan reads all
                 heads of a position together); append writes one
                 contiguous block per token.

    The append terms scale with ``new_tokens`` while the read terms scale
    with the history, so prefill-heavy invocations (appends dominate,
    ``T ≳ S``) rank ``pos_major`` first: its reads beat ``row_chunk``
    whenever ``n_chunks < n_heads`` and its position-outer writes beat
    ``head_major``'s per-head scatter once ``T·(H−1) > 2·S·C − 2·H``.
    Decode-dominated invocations (T = 1, appends negligible) still rank
    ``head_major`` first on reads.

    ``batch`` multiplies every term: a batched decode tick runs the same
    per-sequence access pattern for each of the ``batch`` sequences (the
    seq key is the outermost block of the seq-keyed cache tables).
    """
    S, H, C, T = cache_len, n_heads, n_chunks, new_tokens
    scan_rows = 2 * S * H * C  # score join + attn-output join
    if layout == CACHE_ROW_CHUNK:
        read_seg, write_seg = 2 * H * S, T
    elif layout == CACHE_HEAD_MAJOR:
        read_seg, write_seg = 2 * H, T * H
    elif layout == CACHE_POS_MAJOR:
        read_seg, write_seg = 2 * S * C, T
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    return CacheCost(layout=layout, scan_rows=batch * scan_rows,
                     read_segments=batch * read_seg,
                     write_segments=batch * write_seg)


def cache_site_costs(site: "CacheSite", params: CostParams):
    """{layout: total} for every cache layout of a matched cache site.

    Batched sites (``seq_key`` set) price at their batch size: each of the
    ``site.batch`` sequences appends one row and scans its own history per
    tick, regardless of ``params.seq_len``.
    """
    from repro_torch.planner.layout import CACHE_LAYOUTS
    new_tokens = 1 if site.seq_key is not None else params.seq_len
    return {
        layout: cache_layout_cost(layout, site.n_pos, site.n_heads,
                                  site.n_chunks, new_tokens=new_tokens,
                                  batch=site.batch).total(params)
        for layout in CACHE_LAYOUTS
    }


def cache_chunk_costs(site: "CacheSite", params: CostParams,
                      candidates=()):
    """{(layout, chunk_size): total} over the cache's admissible chunk sizes.

    A cache table's chunk size is tied to the pipeline chunking (the
    append path and both attention joins share it with the Q/K/V
    activations), so these prices inform the *global* chunk-size choice
    (``RelationalEngine(chunk_size="auto")`` /
    :func:`repro_torch.planner.calibrate.choose_base_chunk_size`) rather than a
    per-table rewrite; the planner records them on the
    :class:`~repro_torch.planner.row2col.CacheDecision` for inspection.
    """
    from repro_torch.planner.layout import CACHE_LAYOUTS
    head_dim = site.head_dim
    new_tokens = 1 if site.seq_key is not None else params.seq_len
    out = {}
    for cs in site.chunk_candidates(candidates):
        nch = max(1, head_dim // cs)
        for layout in CACHE_LAYOUTS:
            out[(layout, cs)] = cache_layout_cost(
                layout, site.n_pos, site.n_heads, nch,
                new_tokens=new_tokens, batch=site.batch).total(params)
    return out


# ---------------------------------------------------------------------------
# Precision pricing — quantised chunk payloads (ISSUE 5)
# ---------------------------------------------------------------------------


def precision_cost(precision: str, n_elements: int, n_groups: int,
                   params: CostParams) -> float:
    """Per-invocation cost of scanning one weight table at ``precision``.

    The scan streams the stored bytes (payload + per-group scales) through
    the working set — quantised payloads shrink that term — while the
    inline dequant projection touches every element once per invocation
    (zero for f32), weighted by the codec's dequant multiplier.
    """
    from repro_torch.quant.codecs import CODECS, precision_bytes
    nbytes = precision_bytes(precision, n_elements, n_groups)
    if precision == "f32":
        return params.byte_weight * nbytes
    codec = CODECS[precision]
    return (params.byte_weight * nbytes
            + params.dequant_weight * codec.dequant_multiplier * n_elements)


def precision_costs(n_elements: int, n_groups: int, params: CostParams,
                    precisions=None):
    """{precision: cost} over the candidate precisions of one table."""
    from repro_torch.quant.codecs import PRECISIONS
    return {p: precision_cost(p, n_elements, n_groups, params)
            for p in (precisions or PRECISIONS)}


def choose_precision(n_elements: int, n_groups: int, params: CostParams,
                     precisions=None):
    """(precision, costs) minimising :func:`precision_cost`; ties prefer
    the earlier (higher-fidelity) candidate — f32, then int8, then nf4."""
    costs = precision_costs(n_elements, n_groups, params, precisions)
    best = None
    for p, c in costs.items():
        if best is None or c < costs[best]:
            best = p
    return best, costs


def choose_cache_layout(site: "CacheSite",
                        params: Optional[CostParams] = None,
                        costs: Optional[dict] = None) -> str:
    """Cost-based cache-layout choice (ties keep the seed row_chunk).

    Pass ``costs`` (from :func:`cache_site_costs`) to reuse already-priced
    totals — the planner records them on the decision it returns.
    """
    params = params or CostParams()
    if costs is None:
        costs = cache_site_costs(site, params)
    best = min(costs.values())
    if costs[CACHE_ROW_CHUNK] == best:
        return CACHE_ROW_CHUNK
    return min(costs, key=costs.get)
