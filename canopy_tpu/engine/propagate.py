"""Bottom-up probability propagation over the compiled gate graph.

The quantitative core that replaces the reference's absent evaluation
engine: given per-basic-event probabilities (optionally batched over a
trials axis) and house-event states, propagate through the level schedule
to get every gate's probability under the independence assumption.

Memory layout is **node-major**: the working value matrix is
``(n_nodes, n_trials)`` with the trials axis contiguous, so each
argument fetch is a *contiguous row* (coalesced loads of one or more
full cache lines per node) and each level's output is a contiguous
row-block scatter. The batch-leading public API transposes at the
boundary; the trials-leading layout would turn every gather into a
strided column read.

Per level (see ``compiler/graph.py``):

* ``prod`` family — one row gather, one fused conditional complement,
  one product-reduce over the padded fan-in axis, one row-block scatter:
  the CSR-SpMV access pattern in the (x, *) semiring, which becomes the
  SpMM pattern when trials are batched.
* ``pair`` family — closed-form xor/iff on two gathered rows.
* ``count`` family — a Poisson-binomial dynamic program (`lax.scan` over
  the fan-in axis carrying a count distribution with an absorbing cap).
  Exact for atleast/cardinality without combinatorial expansion.

Everything is `jit`/`vmap`/`grad`-compatible.

Exactness note: like any bottom-up probability propagation, results are
exact when no basic event feeds two different argument paths of the same
gate subgraph and approximate otherwise; the BDD engine
(``engine/bdd_eval.py``) is the exact path for shared-event models.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.graph import CompiledTree, CountBlock, LevelBlock, PairBlock, ProdBlock

__all__ = ["propagate_probability", "top_event_probability",
           "propagate_node_major", "make_propagator",
           "make_staged_propagator", "make_param_propagator"]


def _compute_dtype(vals: jnp.ndarray):
    """Gate math runs in >= f32 even when the value matrix is stored
    narrow (bf16 trials halve HBM rows — the big-tree engine's memory
    ceiling); one rounding per level instead of one per multiply."""
    return jnp.promote_types(vals.dtype, jnp.float32)


def _eval_prod(vals: jnp.ndarray, block: ProdBlock):
    """vals: (n_nodes, B). Returns (out_idx, out (G, B)).

    One fan-in column at a time: each step is a (G, B) row gather fused
    into a multiply — never materializing the (G, F, B) tensor, which
    costs ~3x extra HBM traffic on benchmark-scale trees.
    """
    F = block.arg_idx.shape[1]
    cdt = _compute_dtype(vals)
    acc = None
    for f in range(F):
        v = vals[jnp.asarray(block.arg_idx[:, f])].astype(cdt)
        flip = jnp.asarray(block.arg_flip[:, f])[:, None]
        x = jnp.where(flip, 1.0 - v, v)
        if not block.arg_mask[:, f].all():
            mask = jnp.asarray(block.arg_mask[:, f])[:, None]
            x = jnp.where(mask, x, 1.0)                # Neutral pad.
        acc = x if acc is None else acc * x
    out = jnp.where(jnp.asarray(block.inv_out)[:, None], 1.0 - acc, acc)
    return jnp.asarray(block.out_idx), out


def _eval_pair(vals: jnp.ndarray, block: PairBlock):
    v = vals[block.arg_idx].astype(_compute_dtype(vals))  # (G, 2, B)
    neg = jnp.asarray(block.arg_neg)[..., None]
    v = jnp.where(neg, 1.0 - v, v)
    a, b = v[:, 0, :], v[:, 1, :]
    xor = a + b - 2.0 * a * b
    out = jnp.where(jnp.asarray(block.is_iff)[:, None], 1.0 - xor, xor)
    return jnp.asarray(block.out_idx), out


def _eval_count(vals: jnp.ndarray, block: CountBlock):
    """Poisson-binomial DP with absorbing cap (state ``cap`` = ">= cap")."""
    v = vals[block.arg_idx].astype(_compute_dtype(vals))  # (G, F, B)
    neg = jnp.asarray(block.arg_neg)[..., None]
    mask = jnp.asarray(block.arg_mask)[..., None]
    v = jnp.where(neg, 1.0 - v, v)
    v = jnp.where(mask, v, 0.0)                        # Pad: never true.

    cap = block.cap
    G, _F, B = v.shape
    dp0 = jnp.zeros((G, cap + 1, B), dtype=v.dtype)
    dp0 = dp0.at[:, 0, :].set(1.0)

    def step(dp, p_col):
        p = p_col[:, None, :]                          # (G, 1, B)
        shifted = jnp.concatenate(
            [jnp.zeros_like(dp[:, :1, :]), dp[:, :-1, :]], axis=1)
        new = dp * (1.0 - p) + shifted * p
        new = new.at[:, cap, :].add(dp[:, cap, :] * p[:, 0, :])
        return new, None

    v_scan = jnp.moveaxis(v, 1, 0)                     # (F, G, B)
    dp, _ = jax.lax.scan(step, dp0, v_scan)

    counts = jnp.arange(cap + 1)
    in_range = ((counts[None, :] >= jnp.asarray(block.min_num)[:, None]) &
                (counts[None, :] <= jnp.asarray(block.max_num)[:, None]))
    out = jnp.sum(jnp.where(in_range[..., None], dp, 0.0), axis=1)
    return jnp.asarray(block.out_idx), out


def _write_rows(vals: jnp.ndarray, idx, out: jnp.ndarray) -> jnp.ndarray:
    """Row-block write; contiguous slots (the compiler's family-grouped
    layout) use dynamic-update-slice, which XLA aliases in place instead
    of copying the whole value matrix per level."""
    idx_np = np.asarray(idx)
    if len(idx_np) and (np.diff(idx_np) == 1).all():
        return jax.lax.dynamic_update_slice(vals, out.astype(vals.dtype),
                                            (int(idx_np[0]), 0))
    return vals.at[jnp.asarray(idx_np)].set(out.astype(vals.dtype))


_EVALUATORS = {"prod": _eval_prod, "pair": _eval_pair,
               "count": _eval_count}


def _eval_level(vals: jnp.ndarray, level: LevelBlock) -> jnp.ndarray:
    for kind, block in level.iter_blocks():
        if block.n_gates:
            idx, out = _EVALUATORS[kind](vals, block)
            vals = _write_rows(vals, block.out_idx, out)
    return vals


def propagate_node_major(tree: CompiledTree, basic_nm: jnp.ndarray,
                         house_nm: jnp.ndarray) -> jnp.ndarray:
    """Core pass. ``basic_nm``: (n_basic, B); returns (n_nodes, B)."""
    B = basic_nm.shape[-1]
    parts = [basic_nm]
    if tree.n_house:
        parts.append(jnp.broadcast_to(house_nm, (tree.n_house, B))
                     .astype(basic_nm.dtype))
    parts.append(jnp.zeros((tree.n_gates, B), dtype=basic_nm.dtype))
    vals = jnp.concatenate(parts, axis=0)
    for level in tree.levels:
        vals = _eval_level(vals, level)
    return vals


def _to_node_major(tree: CompiledTree, basic_p, house_states):
    batch_shape = jnp.shape(basic_p)[:-1]
    if tree.n_house:
        batch_shape = jnp.broadcast_shapes(
            batch_shape, jnp.shape(house_states)[:-1])
    B = math.prod(batch_shape) if batch_shape else 1
    basic_p = jnp.broadcast_to(basic_p, batch_shape + (tree.n_basic,))
    basic_nm = jnp.reshape(basic_p, (B, tree.n_basic)).T
    house_nm = jnp.reshape(
        jnp.broadcast_to(house_states, batch_shape + (tree.n_house,)),
        (B, tree.n_house)).T if tree.n_house else \
        jnp.zeros((0, B), dtype=basic_nm.dtype)
    return basic_nm, house_nm, batch_shape


def propagate_probability(tree: CompiledTree, basic_p: jnp.ndarray,
                          house_states: jnp.ndarray) -> jnp.ndarray:
    """Batch-leading API: (..., n_basic) -> (..., n_nodes)."""
    basic_nm, house_nm, batch_shape = _to_node_major(tree, basic_p,
                                                     house_states)
    vals = propagate_node_major(tree, basic_nm, house_nm)
    return jnp.reshape(vals.T, batch_shape + (tree.n_nodes,))


def top_event_probability(tree: CompiledTree, basic_p: jnp.ndarray,
                          house_states: jnp.ndarray | None = None) -> jnp.ndarray:
    """The top event's probability (requires ``tree.top_index``)."""
    if house_states is None:
        house_states = jnp.asarray(tree.house_state_vector())
    basic_nm, house_nm, batch_shape = _to_node_major(tree, basic_p,
                                                     house_states)
    vals = propagate_node_major(tree, basic_nm, house_nm)
    return jnp.reshape(vals[tree.top_index], batch_shape)


def _build_house(tree: CompiledTree,
                 house_states: np.ndarray | None) -> np.ndarray:
    if house_states is None:
        return tree.house_state_vector()
    return np.asarray(house_states, dtype=np.float64)


#: Engine names :func:`make_propagator` accepts.
ENGINES = ("auto", "gather")


def make_propagator(tree: CompiledTree, output: str = "top",
                    engine: str = "auto",
                    house_states: np.ndarray | None = None):
    """A jitted closure ``f(basic_p, house_states=None) -> prob``.

    ``house_states`` sets the default house-event vector (default: the
    tree's current states); a per-call ``house_states`` overrides it.

    ``output``: "top" for the top-event value, "all" for the full value
    vector. ``engine``: "gather" (this module's level-scheduled engine)
    or "auto", which is the same engine; any other name raises
    :class:`ValueError`. Top-only queries evaluate the top event's cone
    (``compiler/graph.prune_to_top_cone``, bit-identical). One
    compilation serves any number of probability vectors (time steps,
    uncertainty trials, importance gradients).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown propagation engine {engine!r}; "
                         f"expected one of {ENGINES}")
    baked = _build_house(tree, house_states)
    if output == "top":
        eval_tree = tree
        if tree.top_index is not None:
            from ..compiler.graph import prune_to_top_cone
            eval_tree = prune_to_top_cone(tree)

        def fn(basic_p, house_states=None):
            h = jnp.asarray(baked) if house_states is None else house_states
            return top_event_probability(eval_tree, basic_p, h)
    else:
        def fn(basic_p, house_states=None):
            h = jnp.asarray(baked) if house_states is None else house_states
            return propagate_probability(tree, basic_p, h)
    return jax.jit(fn)


def make_staged_propagator(tree: CompiledTree,
                           house_states: np.ndarray | None = None):
    """An amortizing ``(stage, run)`` pair for hot loops:
    ``run(stage(basic_p))`` is the top value.  The gather engine needs no
    input layout transform, so ``stage`` is the identity and ``run`` the
    top-cone gather evaluation."""
    from ..compiler.graph import prune_to_top_cone
    house = _build_house(tree, house_states)
    cone = prune_to_top_cone(tree) if tree.top_index is not None else tree

    def run_gather(basic_p):
        return top_event_probability(cone, basic_p, jnp.asarray(house))
    return jax.jit(lambda p: p), jax.jit(run_gather)


def make_param_propagator(tree: CompiledTree):
    """The gather engine with index arrays as arguments, not
    closed-over constants.

    Million-gate trees carry tens of MB of index arrays; passed as
    arguments they stay device buffers instead of constants folded into
    the compiled program, and can be donated or resharded.  The host
    precomputes only the static structure (family kinds, shapes,
    contiguity, padding masks) and returns ``(fn, params)``:
    ``params`` is a pytree of device arrays passed per call, and
    ``fn(params, basic_p, house_states) -> (..., top)`` is jit-safe
    with ``params`` traced.  Results are bit-identical to
    :func:`top_event_probability` (same ops, same order).
    """
    from ..errors import LogicError
    if tree.top_index is None:
        raise LogicError("make_param_propagator needs an anchored top")
    params: list = []
    spec: list = []    # static mirror: (kind, static-fields...)
    for level in tree.levels:
        for kind, b in level.iter_blocks():
            if not b.n_gates:
                continue
            idx_np = np.asarray(b.out_idx)
            contig = bool(len(idx_np)
                          and (np.diff(idx_np) == 1).all())
            out0 = int(idx_np[0]) if contig else None
            if kind == "prod":
                arrays = dict(arg_idx=jnp.asarray(b.arg_idx),
                              arg_flip=jnp.asarray(b.arg_flip),
                              inv_out=jnp.asarray(b.inv_out))
                full = [bool(b.arg_mask[:, f].all())
                        for f in range(b.arg_idx.shape[1])]
                if not all(full):
                    arrays["arg_mask"] = jnp.asarray(b.arg_mask)
                if not contig:
                    arrays["out_idx"] = jnp.asarray(idx_np)
                spec.append(("prod", full, contig, out0))
            elif kind == "pair":
                arrays = dict(arg_idx=jnp.asarray(b.arg_idx),
                              arg_neg=jnp.asarray(b.arg_neg),
                              is_iff=jnp.asarray(b.is_iff))
                if not contig:
                    arrays["out_idx"] = jnp.asarray(idx_np)
                spec.append(("pair", contig, out0))
            else:
                arrays = dict(arg_idx=jnp.asarray(b.arg_idx),
                              arg_neg=jnp.asarray(b.arg_neg),
                              arg_mask=jnp.asarray(b.arg_mask),
                              min_num=jnp.asarray(b.min_num),
                              max_num=jnp.asarray(b.max_num))
                if not contig:
                    arrays["out_idx"] = jnp.asarray(idx_np)
                spec.append(("count", b.cap, contig, out0))
            params.append(arrays)
    n_basic, n_house, n_gates = tree.n_basic, tree.n_house, tree.n_gates
    top_index = tree.top_index

    def _write(vals, arrays, contig, out0, out):
        if contig:
            return jax.lax.dynamic_update_slice(
                vals, out.astype(vals.dtype), (out0, 0))
        return vals.at[arrays["out_idx"]].set(out.astype(vals.dtype))

    def fn(params, basic_p, house_states):
        """(T, n_basic), (n_house,) -> (T,) top values."""
        B = basic_p.shape[0]
        basic_nm = basic_p.T
        parts = [basic_nm]
        if n_house:
            parts.append(jnp.broadcast_to(house_states[:, None],
                                          (n_house, B))
                         .astype(basic_nm.dtype))
        parts.append(jnp.zeros((n_gates, B), dtype=basic_nm.dtype))
        vals = jnp.concatenate(parts, axis=0)
        for arrays, sp in zip(params, spec):
            kind = sp[0]
            cdt = _compute_dtype(vals)
            if kind == "prod":
                _k, full, contig, out0 = sp
                F = arrays["arg_idx"].shape[1]
                acc = None
                for f in range(F):
                    v = vals[arrays["arg_idx"][:, f]].astype(cdt)
                    x = jnp.where(arrays["arg_flip"][:, f][:, None],
                                  1.0 - v, v)
                    if not full[f]:
                        x = jnp.where(arrays["arg_mask"][:, f][:, None],
                                      x, 1.0)
                    acc = x if acc is None else acc * x
                out = jnp.where(arrays["inv_out"][:, None],
                                1.0 - acc, acc)
            elif kind == "pair":
                _k, contig, out0 = sp
                v = vals[arrays["arg_idx"]].astype(cdt)
                v = jnp.where(arrays["arg_neg"][..., None], 1.0 - v, v)
                a, b_ = v[:, 0, :], v[:, 1, :]
                x = a + b_ - 2.0 * a * b_
                out = jnp.where(arrays["is_iff"][:, None], 1.0 - x, x)
            else:
                _k, cap, contig, out0 = sp
                v = vals[arrays["arg_idx"]].astype(cdt)
                v = jnp.where(arrays["arg_neg"][..., None], 1.0 - v, v)
                v = jnp.where(arrays["arg_mask"][..., None], v, 0.0)
                G, _F, Bx = v.shape
                dp0 = jnp.zeros((G, cap + 1, Bx), dtype=v.dtype)
                dp0 = dp0.at[:, 0, :].set(1.0)

                def step(dp, p_col):
                    p = p_col[:, None, :]
                    shifted = jnp.concatenate(
                        [jnp.zeros_like(dp[:, :1, :]), dp[:, :-1, :]],
                        axis=1)
                    new = dp * (1.0 - p) + shifted * p
                    new = new.at[:, cap, :].add(dp[:, cap, :]
                                                * p[:, 0, :])
                    return new, None

                dp, _ = jax.lax.scan(step, dp0, jnp.moveaxis(v, 1, 0))
                counts = jnp.arange(cap + 1)
                in_range = ((counts[None, :]
                             >= arrays["min_num"][:, None]) &
                            (counts[None, :]
                             <= arrays["max_num"][:, None]))
                out = jnp.sum(jnp.where(in_range[..., None], dp, 0.0),
                              axis=1)
            vals = _write(vals, arrays, contig, out0, out)
        return vals[top_index]

    return fn, params


def mean_basic_probabilities(tree: CompiledTree) -> np.ndarray:
    """Host-side mean probability vector from the MEF expressions."""
    return np.array([event.p() for event in tree.basic_events],
                    dtype=np.float64)
