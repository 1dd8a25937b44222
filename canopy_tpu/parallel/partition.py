"""Row-partitioned gate propagation: the tensor-parallel compute path.

The scale-out structure of BASELINE.json config 5: the gate-structure
matrix is **row-partitioned over the mesh's ``model`` axis** — each device
owns a block of every level's gates — while the trials axis stays sharded
over ``data``. Per level, each device:

1. evaluates its row block against its (replicated) copy of the value
   matrix (gather ➜ flip ➜ reduce, as in the single-chip engine), then
2. exchanges the *newly produced gate rows only* with an
   `all_gather(axis="model")` — the halo exchange; level outputs are
   contiguous row ranges, so the gathered block drops into the value
   matrix with one dynamic-update-slice.

The collective payload per level is exactly the level's output rows (not
the whole value matrix), which is the minimal halo for a row partition.
Padding rows (to make blocks divisible) duplicate row 0 and are sliced
off after the gather — identity by construction.

On GPUs the all-gather is an NCCL collective over NVLink, where every
card reaches every other at the same rate; the ``data`` axis never
communicates until the final statistics psum.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..compiler.graph import CompiledTree, CountBlock, PairBlock, ProdBlock

__all__ = ["make_partitioned_propagator"]


def _pad_rows(array: np.ndarray, multiple: int) -> np.ndarray:
    rows = array.shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return array
    reps = [array[:1]] * (target - rows)
    return np.concatenate([array] + reps, axis=0)


@dataclasses.dataclass
class _PaddedLevel:
    kind: str                 # "prod" | "pair" | "count"
    out_start: int
    n_real: int
    arrays: tuple             # family-specific numpy arrays, row-padded
    aux: tuple = ()


def _plan_levels(tree: CompiledTree, n_model: int) -> list[_PaddedLevel]:
    plan: list[_PaddedLevel] = []
    for level in tree.levels:
        for kind, b in level.iter_blocks():
            if not b.n_gates:
                continue
            if kind == "prod":
                plan.append(_PaddedLevel(
                    "prod", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_flip, n_model),
                     _pad_rows(b.arg_mask, n_model),
                     _pad_rows(b.inv_out[:, None], n_model))))
            elif kind == "pair":
                plan.append(_PaddedLevel(
                    "pair", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_neg, n_model),
                     _pad_rows(b.is_iff[:, None], n_model))))
            else:
                plan.append(_PaddedLevel(
                    "count", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_neg, n_model),
                     _pad_rows(b.arg_mask, n_model),
                     _pad_rows(b.min_num[:, None], n_model),
                     _pad_rows(b.max_num[:, None], n_model)),
                    aux=(b.cap,)))
    return plan


def _eval_prod_local(vals, arg_idx, arg_flip, arg_mask, inv_out):
    acc = None
    for f in range(arg_idx.shape[1]):
        v = vals[arg_idx[:, f]]
        x = jnp.where(arg_flip[:, f][:, None], 1.0 - v, v)
        x = jnp.where(arg_mask[:, f][:, None], x, 1.0)
        acc = x if acc is None else acc * x
    return jnp.where(inv_out, 1.0 - acc, acc)


def _eval_pair_local(vals, arg_idx, arg_neg, is_iff):
    v = vals[arg_idx]
    v = jnp.where(arg_neg[..., None], 1.0 - v, v)
    xor = v[:, 0] + v[:, 1] - 2.0 * v[:, 0] * v[:, 1]
    return jnp.where(is_iff, 1.0 - xor, xor)


def _eval_count_local(vals, arg_idx, arg_neg, arg_mask, min_num, max_num,
                      cap):
    v = vals[arg_idx]
    v = jnp.where(arg_neg[..., None], 1.0 - v, v)
    v = jnp.where(arg_mask[..., None], v, 0.0)
    G, _F, B = v.shape
    dp0 = jnp.zeros((G, cap + 1, B), dtype=v.dtype).at[:, 0, :].set(1.0)

    def step(dp, p_col):
        p = p_col[:, None, :]
        shifted = jnp.concatenate(
            [jnp.zeros_like(dp[:, :1, :]), dp[:, :-1, :]], axis=1)
        new = dp * (1.0 - p) + shifted * p
        new = new.at[:, cap, :].add(dp[:, cap, :] * p[:, 0, :])
        return new, None

    dp, _ = jax.lax.scan(step, dp0, jnp.moveaxis(v, 1, 0))
    counts = jnp.arange(cap + 1)
    in_range = ((counts[None, :] >= min_num) & (counts[None, :] <= max_num))
    return jnp.sum(jnp.where(in_range[..., None], dp, 0.0), axis=1)


def make_partitioned_propagator(tree: CompiledTree, mesh: Mesh):
    """jitted (basic_p (T, n_basic), house (n_house,)) -> top probs (T,).

    Gate rows sharded over "model" (halo all-gather per level); trials
    over "data".
    """
    n_model = mesh.shape["model"]
    plan = _plan_levels(tree, n_model)

    # Flatten plan arrays into shard_map operands with P("model", ...)
    operand_arrays = []
    operand_specs = []
    for entry in plan:
        for arr in entry.arrays:
            operand_arrays.append(jnp.asarray(arr))
            operand_specs.append(P("model") if arr.ndim == 1
                                 else P("model", *([None] * (arr.ndim - 1))))

    def local_fn(basic_nm, house_nm, *blocks):
        # basic_nm: (n_basic, T_local) — replicated over "model".
        B = basic_nm.shape[-1]
        parts = [basic_nm]
        if tree.n_house:
            parts.append(jnp.broadcast_to(house_nm[:, None],
                                          (tree.n_house, B))
                         .astype(basic_nm.dtype))
        parts.append(jnp.zeros((tree.n_gates, B), dtype=basic_nm.dtype))
        vals = jnp.concatenate(parts, axis=0)

        cursor = 0
        for entry in plan:
            n_arrays = len(entry.arrays)
            local_arrays = blocks[cursor:cursor + n_arrays]
            cursor += n_arrays
            if entry.kind == "prod":
                out_local = _eval_prod_local(vals, *local_arrays)
            elif entry.kind == "pair":
                out_local = _eval_pair_local(vals, *local_arrays)
            else:
                out_local = _eval_count_local(vals, *local_arrays,
                                              entry.aux[0])
            # Halo exchange: only the new rows travel.
            out_full = jax.lax.all_gather(out_local, "model", axis=0,
                                          tiled=True)
            vals = jax.lax.dynamic_update_slice(
                vals, out_full[:entry.n_real].astype(vals.dtype),
                (entry.out_start, 0))
        return vals[tree.top_index]

    # check_vma off: the count-family lax.scan carries start as
    # unvarying constants and become device-varying inside the loop,
    # which the static varying-axis checker cannot express.
    try:
        sharded = shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, "data"), P(None), *operand_specs),
            out_specs=P("data"), check_vma=False)
    except TypeError:  # pragma: no cover - older jax spelling
        sharded = shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, "data"), P(None), *operand_specs),
            out_specs=P("data"), check_rep=False)

    @jax.jit
    def propagate(basic_p, house):
        basic_nm = basic_p.T
        top = sharded(basic_nm, house, *operand_arrays)
        return top

    return propagate
