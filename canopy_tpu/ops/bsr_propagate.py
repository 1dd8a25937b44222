"""BSR log-space propagation: gate evaluation as block-sparse matmuls.

An alternative to row gathers: instead of gathering one value row per argument edge, each
level becomes a **block-sparse matrix multiply in log space**:

    x_edge  = flip ? (1 - v_src) : v_src          (edge literal)
    y_gate  = sum_edges log(x_edge)               (product in log space)
    value   = inv_out ? 1 - exp(y) : exp(y)

The log-sum is ``S @ L`` where ``S`` is the 0/1 level structure matrix
over a **doubled column space** — column ``c`` reads ``log(v_c)``,
column ``N + c`` reads ``log(1 - v_c)`` — so per-edge flips cost nothing.
``S`` is stored as BSR: 128-gate row blocks x 128-column blocks, each a
dense f32 tile fed to the matrix units. Device memory then sees *block*
gathers
(128 rows x trials at a stride) instead of scattered single rows — the
streaming-friendly pattern — and the multiply itself rides the matrix
units' FLOP surplus (fill-in waste is paid in idle-FLOPs, not bandwidth).

Effectiveness depends on argument locality (how few column blocks each
row block touches). Real PRA trees have strong subsystem locality; the
compiler's level ordering preserves it, and graph partitioning to
*create* it for unstructured models is the designated follow-up. The
evaluator reports its fill ratio so callers can choose between this and
the gather engine per model (``bsr_cost_report``).

Numerics: logs are clamped at -1e4 (exp underflows to exactly 0 in f32),
so hard 0/1 inputs stay exact; otherwise f32 log/exp round-trip error is
~1e-6 relative — the same class as the f32 product engine.  The einsum
asks for HIGHEST precision, so a GPU does not run it in TF32.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.graph import CompiledTree
from ..errors import LogicError

__all__ = ["compile_bsr", "bsr_arrays", "bsr_top_probability",
           "bsr_cost_report", "estimate_bsr_fill"]

_BLOCK = 128        # Column block (matmul contraction dim).
# Default row block.  Wider row blocks amortize each gathered 128-column
# slab over more gates (HBM floats/nnz at 8/32 on the reordered
# branching-8 hierarchical bench: 9.5/5.0) but store proportionally
# larger mostly-zero tiles (fill 76x/161x); 128-row tiles are
# impractical (tile arrays reach hundreds of MB).  Its speed on the GPU
# is not measured yet.
_ROW_BLOCK = 8
_LOG_CLAMP = -1e4


@dataclasses.dataclass
class _BsrLevel:
    out_start: int            # First gate slot of the level (contiguous).
    n_gates: int
    n_row_blocks: int
    row_block: int
    # Flattened (row_block, col_block) pairs:
    pair_rows: np.ndarray     # (P,) row-block index within the level
    pair_cols: np.ndarray     # (P,) col-block index into the doubled space
    blocks: np.ndarray        # (P, ROW_BLOCK, 128) f32 structure tiles
    inv_out: np.ndarray       # (n_gates,) bool


@dataclasses.dataclass
class BsrProgram:
    n_nodes: int
    n_pad: int                # Node count padded to a block multiple.
    n_basic: int
    n_house: int
    top_index: int
    levels: list[_BsrLevel]
    nnz: int
    fill_blocks: int          # Total (row_block x 128) tiles stored.
    row_block: int = _ROW_BLOCK

    @property
    def fill_ratio(self) -> float:
        """Stored tile entries per structural nonzero (the matmul waste)."""
        return self.fill_blocks * self.row_block * _BLOCK / max(self.nnz, 1)

    @property
    def hbm_floats_per_nnz(self) -> float:
        """Gathered column-slab floats per nnz — the actual bandwidth
        cost model (tile count x 128, NOT tile entries)."""
        return self.fill_blocks * _BLOCK / max(self.nnz, 1)


def compile_bsr(tree: CompiledTree,
                row_block: int = _ROW_BLOCK) -> BsrProgram:
    """Build the per-level BSR structure from a compiled tree.

    Requires prod-family-only levels (the benchmark/production fast path;
    pair/count gates fall back to the gather engine).
    """
    levels: list[_BsrLevel] = []
    fill_blocks = 0
    n_pad = -(-tree.n_nodes // _BLOCK) * _BLOCK
    for level in tree.levels:
        if level.pairs or level.counts:
            raise LogicError(
                "BSR propagation supports product-family levels only.")
        if not level.prods:
            continue
        # Merge the level's buckets into one row-ordered edge list
        # (vectorized: benchmark-scale levels have millions of edges).
        out_start = min(int(b.out_idx[0]) for b in level.prods)
        n_gates = sum(b.n_gates for b in level.prods)
        inv_out = np.zeros(n_gates, dtype=bool)
        n_row_blocks = -(-n_gates // row_block)
        rows_list, cols_list = [], []
        for block in level.prods:
            rows_b = np.repeat(block.out_idx.astype(np.int64) - out_start,
                               block.arg_idx.shape[1])
            cols_b = block.arg_idx.astype(np.int64).reshape(-1)
            cols_b = cols_b + np.where(block.arg_flip.reshape(-1), n_pad, 0)
            keep = block.arg_mask.reshape(-1)
            rows_list.append(rows_b[keep])
            cols_list.append(cols_b[keep])
            inv_out[block.out_idx - out_start] = block.inv_out
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        rb, r_in = np.divmod(rows, row_block)
        cb, c_in = np.divmod(cols, _BLOCK)
        pair_key = rb * (2 * n_pad // _BLOCK) + cb
        unique_keys, pair_of_edge = np.unique(pair_key,
                                              return_inverse=True)
        tiles = np.zeros((len(unique_keys), row_block, _BLOCK),
                         dtype=np.float32)
        np.add.at(tiles, (pair_of_edge, r_in, c_in), 1.0)
        levels.append(_BsrLevel(
            out_start=out_start, n_gates=n_gates,
            n_row_blocks=n_row_blocks,
            pair_rows=(unique_keys // (2 * n_pad // _BLOCK))
            .astype(np.int32),
            pair_cols=(unique_keys % (2 * n_pad // _BLOCK))
            .astype(np.int32),
            blocks=tiles, inv_out=inv_out, row_block=row_block))
        fill_blocks += len(unique_keys)
    return BsrProgram(n_nodes=tree.n_nodes, n_pad=n_pad,
                      n_basic=tree.n_basic,
                      n_house=tree.n_house, top_index=tree.top_index,
                      levels=levels, nnz=tree.nnz, fill_blocks=fill_blocks,
                      row_block=row_block)


def bsr_arrays(program: BsrProgram) -> list[tuple]:
    """The program's device arrays as an argument pytree.

    Pass these through jit boundaries instead of letting the trace embed
    them as constants — benchmark-scale tile sets would otherwise bloat
    the serialized program past compile-service size limits.
    """
    return [(jnp.asarray(level.blocks), jnp.asarray(level.pair_cols),
             jnp.asarray(level.pair_rows), jnp.asarray(level.inv_out))
            for level in program.levels]


def bsr_top_probability(program: BsrProgram, basic_p: jnp.ndarray,
                        house_states: jnp.ndarray | None = None,
                        t_chunk: int = 256,
                        params: list[tuple] | None = None) -> jnp.ndarray:
    """(T, n_basic) -> (T,) top probabilities through the BSR engine.

    The trials axis is processed in ``t_chunk`` slabs (via `lax.map`)
    to bound the materialized gathered-block workspace at
    ``tiles x 128 x t_chunk`` floats.
    """
    if params is None:
        params = bsr_arrays(program)
    T = basic_p.shape[0]
    if T > t_chunk and T % t_chunk == 0:
        chunks = basic_p.reshape(T // t_chunk, t_chunk, -1)
        out = jax.lax.map(
            lambda c: bsr_top_probability(program, c, house_states,
                                          t_chunk=t_chunk, params=params),
            chunks)
        return out.reshape(T)
    dtype = jnp.float32
    basic_nm = basic_p.T.astype(dtype)                    # (n_basic, T)
    parts = [basic_nm]
    if program.n_house:
        house = jnp.broadcast_to(
            jnp.asarray(house_states, dtype)[:, None],
            (program.n_house, T))
        parts.append(house)
    # The state is the doubled log matrix L = [log v | log(1-v)], updated
    # *incrementally*: only each level's newly produced rows get their
    # logs recomputed (a full-log pass per level would dominate traffic).
    n_pad = program.n_pad
    inputs = jnp.concatenate(
        parts + [jnp.zeros((n_pad - program.n_basic - program.n_house, T),
                           dtype=dtype)], axis=0)

    def logs_of(v):
        lv = jnp.maximum(jnp.log(jnp.maximum(v, 1e-300)), _LOG_CLAMP)
        l1 = jnp.maximum(jnp.log(jnp.maximum(1.0 - v, 1e-300)), _LOG_CLAMP)
        return lv, l1

    log_v0, log_1v0 = logs_of(inputs)
    L = jnp.concatenate([log_v0, log_1v0], axis=0)        # (2*n_pad, T)
    top_value = None

    for level, (blocks, pair_cols, pair_rows, inv_out) in zip(
            program.levels, params):
        L_blocks = L.reshape(-1, _BLOCK, T)
        gathered = L_blocks[pair_cols]                     # (P, 128, T)
        # HIGHEST: a float32 product would otherwise run in TF32 on
        # GPUs (about three decimal digits), far too coarse for logs.
        partial = jnp.einsum("prc,pct->prt", blocks, gathered,
                             preferred_element_type=dtype,
                             precision=jax.lax.Precision.HIGHEST)
        y = jax.ops.segment_sum(partial, pair_rows,
                                num_segments=level.n_row_blocks)
        y = y.reshape(level.n_row_blocks * level.row_block,
                      T)[:level.n_gates]
        prod = jnp.exp(y)
        out = jnp.where(inv_out[:, None], 1.0 - prod, prod)
        lo = level.out_start
        if lo <= program.top_index < lo + level.n_gates:
            top_value = out[program.top_index - lo]
        new_lv, new_l1 = logs_of(out)
        L = jax.lax.dynamic_update_slice(L, new_lv, (lo, 0))
        L = jax.lax.dynamic_update_slice(L, new_l1, (n_pad + lo, 0))
    assert top_value is not None, "top gate not covered by any level"
    return top_value


def estimate_bsr_fill(tree: CompiledTree,
                      row_block: int = _ROW_BLOCK) -> float:
    """The fill ratio :func:`compile_bsr` would produce, without
    materializing any tile (used for ordering selection: the reorder
    pass evaluates candidate permutations by this number)."""
    n_pad = -(-tree.n_nodes // _BLOCK) * _BLOCK
    tiles = 0
    nnz = 0
    for level in tree.levels:
        if not level.prods:
            continue
        out_start = min(int(b.out_idx[0]) for b in level.prods)
        keys = []
        for block in level.prods:
            rows_b = np.repeat(block.out_idx.astype(np.int64) - out_start,
                               block.arg_idx.shape[1])
            cols_b = block.arg_idx.astype(np.int64).reshape(-1)
            cols_b = cols_b + np.where(block.arg_flip.reshape(-1), n_pad, 0)
            keep = block.arg_mask.reshape(-1)
            keys.append((rows_b[keep] // row_block)
                        * (2 * n_pad // _BLOCK)
                        + cols_b[keep] // _BLOCK)
            nnz += int(keep.sum())
        tiles += len(np.unique(np.concatenate(keys)))
    return tiles * row_block * _BLOCK / max(nnz, 1)


def bsr_cost_report(program: BsrProgram) -> dict:
    return {"nnz": program.nnz,
            "tiles": program.fill_blocks,
            "fill_ratio": program.fill_ratio,
            "levels": len(program.levels)}
