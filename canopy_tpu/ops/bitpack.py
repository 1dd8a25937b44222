"""Bit-packed Monte-Carlo state evaluation: 32 trials per uint32 lane.

The data-parallel Boolean engine the reference's CI promises
(``./src/bool/bool`` run per accelerator backend — SURVEY.md §0):
Bernoulli basic-event states are packed 32-per-word, and every gate
evaluates with pure bitwise ops, cutting device-memory traffic per trial
by 32x versus float states — the dominant cost of deep-tree simulation
at scale.

Gate families (mirroring ``compiler/graph.py``):

* ``prod`` — ``out = inv_out ^ AND_f (flip ^ arg)`` with all-ones padding;
* ``pair`` — bitwise xor / xnor;
* ``count`` (atleast/cardinality) — a **bit-sliced ripple-carry counter**:
  per gate, B = ceil(log2(F+1)) uint32 planes accumulate the per-trial
  argument count entirely with and/xor, then a bitwise magnitude
  comparator tests ``count >= k`` lane-parallel. No unpacking anywhere.

Everything is jnp: XLA fuses the bitwise chains, and the Bernoulli draw
(``jax.random``) with the threshold-and-pack step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.graph import CompiledTree, CountBlock, PairBlock, ProdBlock

__all__ = ["pack_states", "sample_states_packed", "propagate_packed",
           "packed_top_probability", "popcount_mean"]

_FULL = np.uint32(0xFFFFFFFF)


def pack_states(states: jnp.ndarray) -> jnp.ndarray:
    """(n_trials, n_nodes) {0,1} -> (n_nodes, n_words) uint32.

    Trial t lands in word t//32, bit t%32. n_trials must be a multiple
    of 32.
    """
    n_trials, n_nodes = states.shape
    assert n_trials % 32 == 0, "n_trials must be a multiple of 32"
    bits = states.astype(jnp.uint32).T            # (n_nodes, n_trials)
    bits = bits.reshape(n_nodes, n_trials // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


def sample_states_packed(key, basic_p: jnp.ndarray,
                         n_trials: int) -> jnp.ndarray:
    """Packed Bernoulli states: (n_basic, n_trials//32) uint32.

    One uniform draw per (event, trial) bit, thresholded against p and
    packed 32 trials to a word.
    """
    assert n_trials % 32 == 0
    n_basic = basic_p.shape[-1]
    u = jax.random.uniform(key, (n_trials, n_basic), dtype=jnp.float32)
    states = (u < basic_p[None, :].astype(jnp.float32))
    return pack_states(states)


def _prod_packed(vals, block: ProdBlock):
    v = vals[block.arg_idx]                      # (G, F, W)
    flip = jnp.asarray(block.arg_flip)[..., None]
    mask = jnp.asarray(block.arg_mask)[..., None]
    x = jnp.where(flip, ~v, v)
    x = jnp.where(mask, x, jnp.uint32(_FULL))    # AND identity.
    acc = x[:, 0, :]
    for f in range(1, x.shape[1]):
        acc = acc & x[:, f, :]
    out = jnp.where(jnp.asarray(block.inv_out)[:, None], ~acc, acc)
    return jnp.asarray(block.out_idx), out


def _pair_packed(vals, block: PairBlock):
    v = vals[block.arg_idx]                      # (G, 2, W)
    neg = jnp.asarray(block.arg_neg)[..., None]
    v = jnp.where(neg, ~v, v)
    x = v[:, 0, :] ^ v[:, 1, :]
    out = jnp.where(jnp.asarray(block.is_iff)[:, None], ~x, x)
    return jnp.asarray(block.out_idx), out


def _count_packed(vals, block: CountBlock):
    """Bit-sliced counting + lane-parallel magnitude comparison."""
    v = vals[block.arg_idx]                      # (G, F, W)
    neg = jnp.asarray(block.arg_neg)[..., None]
    mask = jnp.asarray(block.arg_mask)[..., None]
    x = jnp.where(neg, ~v, v)
    x = jnp.where(mask, x, jnp.uint32(0))        # Padding never counts.

    G, F, W = x.shape
    n_planes = max(int(np.ceil(np.log2(F + 1))), 1)
    planes = [jnp.zeros((G, W), dtype=jnp.uint32) for _ in range(n_planes)]
    for f in range(F):
        carry = x[:, f, :]
        for b in range(n_planes):
            planes[b], carry = planes[b] ^ carry, planes[b] & carry
        # carry out of the top plane cannot happen: F < 2^n_planes.

    def count_geq(k: np.ndarray):
        """Bitwise comparator: lanes where count >= k (per-gate k).

        Thresholds beyond the counter's range (k >= 2^n_planes) are
        unreachable: the comparator would otherwise wrap k modulo the
        plane count and compare against k's low bits only.
        """
        ge = jnp.zeros((G, W), dtype=jnp.uint32)
        eq = jnp.full((G, W), _FULL, dtype=jnp.uint32)
        for b in range(n_planes - 1, -1, -1):
            kb = ((k >> b) & 1).astype(bool)[:, None]
            kb_mask = jnp.where(jnp.asarray(kb), jnp.uint32(_FULL),
                                jnp.uint32(0))
            ge = ge | (eq & planes[b] & ~kb_mask)
            eq = eq & ~(planes[b] ^ kb_mask)
        reachable = (k < (1 << n_planes))[:, None]
        return jnp.where(jnp.asarray(reachable), ge | eq, jnp.uint32(0))

    min_num = np.asarray(block.min_num)
    max_num = np.asarray(block.max_num)
    geq_min = count_geq(min_num) if min_num.max() > 0 else \
        jnp.full((G, W), _FULL, dtype=jnp.uint32)
    gt_max = count_geq(max_num + 1)
    out = geq_min & ~gt_max
    return jnp.asarray(block.out_idx), out


def propagate_packed(tree: CompiledTree, packed_basic: jnp.ndarray,
                     house_states: jnp.ndarray) -> jnp.ndarray:
    """Bitwise bottom-up evaluation; returns (n_nodes, n_words) uint32.

    ``packed_basic``: (n_basic, W) uint32; ``house_states``: (n_house,)
    floats broadcast to all-zero/all-one words.
    """
    n_words = packed_basic.shape[-1]
    parts = [packed_basic.astype(jnp.uint32)]
    if tree.n_house:
        house_words = jnp.where(
            (house_states > 0.5)[:, None], jnp.uint32(_FULL), jnp.uint32(0))
        parts.append(jnp.broadcast_to(house_words,
                                      (tree.n_house, n_words)))
    parts.append(jnp.zeros((tree.n_gates, n_words), dtype=jnp.uint32))
    vals = jnp.concatenate(parts, axis=0)
    evaluators = {"prod": _prod_packed, "pair": _pair_packed,
                  "count": _count_packed}
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            if block.n_gates:
                idx, out = evaluators[kind](vals, block)
                idx_np = np.asarray(block.out_idx)
                if len(idx_np) and (np.diff(idx_np) == 1).all():
                    vals = jax.lax.dynamic_update_slice(
                        vals, out, (int(idx_np[0]), 0))
                else:
                    vals = vals.at[idx].set(out)
    return vals


def popcount_mean(words: jnp.ndarray, n_trials: int) -> jnp.ndarray:
    """Fraction of set bits across the word axis (Bernoulli estimate)."""
    counts = jax.lax.population_count(words)
    return jnp.sum(counts, axis=-1).astype(jnp.float64) / n_trials


#: Uniform draws per chunk of trials (a 1 GiB float32 sample): bounds
#: device memory whatever ``n_trials`` and the event count are.
_CHUNK_ELEMENTS = 1 << 28


def packed_top_probability(tree: CompiledTree, key, basic_p: jnp.ndarray,
                           n_trials: int,
                           house_states: jnp.ndarray | None = None):
    """Monte-Carlo top-event estimate through the bit-packed engine.

    The estimate is over ``n_trials`` rounded up to whole 32-trial words.
    They run in equal chunks of at most ``_CHUNK_ELEMENTS / n_basic``
    trials inside one compiled loop, chunk ``i`` drawing with
    ``fold_in(key, i)``; words past the last trial are drawn but not
    counted.
    """
    if house_states is None:
        house_states = jnp.asarray(tree.house_state_vector())
    n_words = max(-(-n_trials // 32), 1)
    max_words = max(_CHUNK_ELEMENTS // (32 * max(tree.n_basic, 1)), 1)
    n_chunks = -(-n_words // max_words)
    chunk_words = -(-n_words // n_chunks)

    @jax.jit
    def hits(key, basic_p, house_states):
        def body(i, total):
            packed = sample_states_packed(jax.random.fold_in(key, i),
                                          basic_p, 32 * chunk_words)
            top = propagate_packed(tree, packed, house_states)[
                tree.top_index]
            live = i * chunk_words + jnp.arange(chunk_words) < n_words
            count = jnp.sum(jnp.where(live, jax.lax.population_count(top),
                                      0), dtype=jnp.int32)
            return total + count.astype(total.dtype)
        return jax.lax.fori_loop(0, n_chunks, body,
                                 jnp.zeros((), jnp.float64))

    return hits(key, basic_p, house_states) / (32 * n_words)
