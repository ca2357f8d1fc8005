"""Physical-layout planner — the ROW2COL subsystem (paper §ROW2COL).

The relational compiler (``core/opmap``) always emits matmuls against
*row-chunked* weight tables: ``W(j, c, chunk FLOAT[cs])``, joined on the
input-chunk key ``c`` and grouped by the output row ``j``.  That shape
explodes the reduction key into the GROUP BY (``T·m`` groups) and pays a
re-chunk tail (π key-split + ``collect_as_array``) to get back to chunked
vectors.  The paper's ROW2COL optimisation stores the transposed,
column-major table ``W__col(d, c, chunk FLOAT[cs'])`` instead and groups by
the *output chunk*: ``T·m/cs'`` groups, no re-chunk tail, and the join
touches far fewer distinct group keys.

This package makes that a proper whole-model cost-based planning stage:

  ``planner.layout``   the layout IR: ``ROW_CHUNK`` / ``COL_CHUNK`` /
                       ``COL_CHUNK_HEADS`` weight layouts, the cache-layout
                       vocabulary (``row_chunk`` / ``head_major`` /
                       ``pos_major`` key orders), transposed-schema
                       builders, and the legality rules via
                       :func:`match_matmul_site` /
                       :func:`admissible_layouts` /
                       :func:`match_cache_sites`.
  ``planner.cost``     the cost model: rows scanned + join fan-out +
                       GROUP BY cardinality per matmul, parameterised by
                       seq-len and chunk size, plus the decode-attention
                       locality model for cache layouts (contiguous-run
                       counts weighted by ``seek_weight``).
  ``planner.row2col``  the planning pass: :func:`plan_layouts` matches the
                       matmul and cache sites, prices the layouts, runs the
                       *global residency pass* (duplicate column copies are
                       admitted by benefit-per-byte within the pager
                       budget), rewrites the winners in place, and returns
                       a :class:`LayoutPlan` that materialises transposed
                       tables into executor environments and emits the SQL
                       conversion script.

Integration points
------------------
* ``core/passes.postoptimize(pipe, layout_mode=..., cache_mode=...,
  budget_bytes=...)`` runs the planner as a standard post-optimisation
  stage.
* ``core/pipeline.run_pipeline`` consults ``pipe.layout_plan`` to
  materialise column tables (and align cache key orders) in the
  environment on first use; the append step inserts at the cache's
  planner-chosen key axis.
* ``core/sqlgen`` emits layout-annotated DDL (weights *and* caches), the
  transposed join/aggregate SQL for both dialects, and column-listed cache
  INSERTs; :meth:`LayoutPlan.conversion_sql` produces the row→column
  data-conversion script (head-blocked variant included).
* ``serving/engine.RelationalEngine(row2col=..., cache_layout=...)`` are
  the user-facing knobs; in paged residency the pager budget bounds the
  residency pass.

Legality summary: plain two-key matmul weights (``map_linear`` — o-proj,
GLU W1/W2/W3, lm_head) admit ``COL_CHUNK``; per-head projection weights
(``map_linear_heads`` — Q/K/V) admit the head-blocked ``COL_CHUNK_HEADS``;
non-matmul tables (norms, vocabulary value-joins, RoPE frequency tables)
stay ``ROW_CHUNK``.  KV-cache tables admit any of the three cache key
orders.
"""

from repro_torch.planner.cost import (CHUNK_CANDIDATES, CacheCost, CostParams,
                                MatmulCost, best_chunk, cache_chunk_costs,
                                cache_layout_cost, cache_site_costs,
                                choose_cache_layout, choose_layout,
                                choose_precision, col_chunk_cost,
                                colh_chunk_cost, precision_cost,
                                precision_costs, row_chunk_cost,
                                site_chunk_costs, site_costs)
from repro_torch.planner.layout import (CACHE_HEAD_MAJOR, CACHE_KEY_ORDERS,
                                  CACHE_LAYOUTS, CACHE_POS_MAJOR,
                                  CACHE_ROW_CHUNK, COL_CHUNK,
                                  COL_CHUNK_HEADS, ROW_CHUNK, CacheSite,
                                  MatmulSite, admissible_layouts,
                                  cache_schema, col_schema, col_table_name,
                                  colh_schema, colh_table_name,
                                  divisor_candidates, match_cache_sites,
                                  match_matmul_site,
                                  match_value_join_tables)
from repro_torch.planner.row2col import (CACHE_MODES, CHUNK_MODES,
                                   PRECISION_MODES, CacheDecision,
                                   LayoutDecision, LayoutPlan, MODES,
                                   PrecisionDecision, ResidencyPool,
                                   conversion_sql, plan_layouts,
                                   union_conversion_sql)
from repro_torch.planner.shard import (COMBINE_CONCAT, COMBINE_SUM, ShardDecision,
                                 ShardPlan, balanced_ranges,
                                 logical_shard_axis, match_shard_site,
                                 plan_shards, price_shard, shard_table_name)

__all__ = [
    "CACHE_HEAD_MAJOR", "CACHE_KEY_ORDERS", "CACHE_LAYOUTS", "CACHE_MODES",
    "CACHE_POS_MAJOR", "CACHE_ROW_CHUNK", "CHUNK_CANDIDATES", "CHUNK_MODES",
    "COL_CHUNK", "COL_CHUNK_HEADS", "MODES", "PRECISION_MODES", "ROW_CHUNK",
    "COMBINE_CONCAT", "COMBINE_SUM",
    "CacheCost", "CacheDecision", "CacheSite", "CostParams", "MatmulCost",
    "MatmulSite", "LayoutDecision", "LayoutPlan", "PrecisionDecision",
    "ResidencyPool", "ShardDecision", "ShardPlan",
    "admissible_layouts", "balanced_ranges", "best_chunk",
    "cache_chunk_costs",
    "cache_layout_cost", "cache_schema", "cache_site_costs",
    "choose_cache_layout", "choose_layout", "choose_precision",
    "col_chunk_cost", "col_schema", "col_table_name", "colh_chunk_cost",
    "colh_schema", "colh_table_name", "conversion_sql",
    "divisor_candidates", "logical_shard_axis", "match_cache_sites",
    "match_matmul_site", "match_shard_site", "match_value_join_tables",
    "plan_layouts", "plan_shards", "precision_cost", "precision_costs",
    "price_shard", "row_chunk_cost", "shard_table_name",
    "site_chunk_costs", "site_costs", "union_conversion_sql",
]
