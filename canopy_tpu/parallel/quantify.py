"""Sharded quantification steps over a ("data", "model") mesh.

Two complementary idioms (SURVEY.md §2.6, §5):

* **GSPMD annotation** (:func:`sharded_uncertainty_step`): the trials axis
  is laid out over ``data`` with `NamedSharding`; the per-level gate
  computation is replicated in structure but batched over the sharded
  trials axis, so XLA partitions the whole propagation without any
  hand-written collectives — the "annotate shardings, let the compiler
  insert collectives" recipe.
* **Explicit shard_map** (:func:`sharded_cutset_quantifier`): cut-set
  matrix rows are partitioned over ``model`` (each device owns a block of
  products = a CSR row block); per-device partial reductions (rare-event
  sums / MCUB log-sums) meet in a `psum` over ``model`` — the
  tensor-parallel partial-sum pattern, with the trials axis still sharded
  over ``data``. Padding rows are probability-0 products, which are exact
  identities for both reductions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..compiler.graph import CompiledTree
from ..engine.cutset_quantify import CutSetMatrix
from ..engine.propagate import propagate_probability

__all__ = ["sharded_uncertainty_step", "sharded_cutset_quantifier"]


def sharded_uncertainty_step(tree: CompiledTree, mesh: Mesh):
    """jitted (basic_p_batch, house) -> per-trial top probabilities,
    with the trials axis sharded over the mesh's "data" axis."""

    batch_spec = NamedSharding(mesh, P(("data", "model"), None))
    out_spec = NamedSharding(mesh, P(("data", "model")))

    @functools.partial(jax.jit, in_shardings=(batch_spec, None),
                       out_shardings=out_spec)
    def step(basic_p, house):
        vals = propagate_probability(tree, basic_p, house)
        return vals[..., tree.top_index]

    return step


def _pad_rows(array: np.ndarray, multiple: int, fill=0):
    rows = array.shape[0]
    padded = -(-rows // multiple) * multiple
    if padded == rows:
        return array
    pad_width = [(0, padded - rows)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width, constant_values=fill)


def sharded_cutset_quantifier(matrix: CutSetMatrix, mesh: Mesh):
    """jitted (basic_p_batch) -> (rare_event, mcub) per trial.

    Rows (products) are sharded over "model"; trials over "data". Each
    device computes partial sums over its row block; `psum` over "model"
    completes the reduction. Row padding uses an always-false product
    (positive literal of slot 0 with mask off -> probability 1 * 0 mask
    trick is avoided by padding with an explicit zero row: a masked-off
    row yields product probability 1, so a dedicated "dead" flag kills
    padded rows).
    """
    n_model = mesh.shape["model"]
    idx = _pad_rows(matrix.idx, n_model)
    neg = _pad_rows(matrix.neg, n_model)
    mask = _pad_rows(matrix.mask, n_model)
    alive = np.zeros(idx.shape[0], dtype=bool)
    alive[:matrix.n_products] = True

    idx_j = jnp.asarray(idx)
    neg_j = jnp.asarray(neg)
    mask_j = jnp.asarray(mask)
    alive_j = jnp.asarray(alive)

    def local_partial(p_local, idx_l, neg_l, mask_l, alive_l):
        # p_local: (t_local, n_basic); idx_l: (rows_local, order).
        v = p_local[..., idx_l]                       # (t, r, o)
        v = jnp.where(neg_l, 1.0 - v, v)
        v = jnp.where(mask_l, v, 1.0)
        q = jnp.prod(v, axis=-1) * alive_l            # (t, r)
        partial_sum = jnp.sum(q, axis=-1)
        partial_log = jnp.sum(jnp.log1p(-jnp.minimum(q, 1.0 - 1e-18)),
                              axis=-1)
        partial_sum = jax.lax.psum(partial_sum, "model")
        partial_log = jax.lax.psum(partial_log, "model")
        return jnp.minimum(partial_sum, 1.0), -jnp.expm1(partial_log)

    sharded = shard_map(
        local_partial, mesh=mesh,
        in_specs=(P("data", None), P("model", None), P("model", None),
                  P("model", None), P("model")),
        out_specs=(P("data"), P("data")))

    @jax.jit
    def quantify(basic_p):
        return sharded(basic_p, idx_j, neg_j, mask_j,
                       alive_j.astype(basic_p.dtype))

    return quantify
