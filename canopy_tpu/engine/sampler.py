"""Monte-Carlo state sampling: the aleatory simulation engine.

Replaces the reference's planned data-parallel Boolean evaluation binary
(``./src/bool/bool``, SURVEY.md §0) with two device engines:

* :func:`sample_top_probability` — float 0/1 states, reusing the same
  level blocks as probability propagation (a Bernoulli state is a
  probability that happens to be 0 or 1, and every gate family maps 0/1
  inputs to the exact Boolean output). Simple, differentiable, and
  vmap-sharded over the mesh.
* :func:`bitpacked` (``ops/bitpack.py``) — 32 trials per uint32 lane with
  bitwise gate evaluation and bit-sliced counters for atleast/cardinality:
  the speed-of-light path, 32x the trial throughput per byte of HBM
  traffic.

Sampling is deterministic per (seed, device count): states come from
counter-based `jax.random` keys, not a shared serial RNG (fixing
``random_deviate.h:20-24``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..compiler.graph import CompiledTree
from .propagate import propagate_probability

__all__ = ["sample_states", "sample_top_probability", "monte_carlo_ci"]


def sample_states(key, basic_p: jnp.ndarray, n_trials: int) -> jnp.ndarray:
    """Bernoulli basic-event states, shape (n_trials, n_basic) in {0.,1.}.

    ``basic_p`` may itself be batched (n_trials, n_basic) — epistemic and
    aleatory sampling compose.
    """
    n_basic = basic_p.shape[-1]
    u = jax.random.uniform(key, (n_trials, n_basic), dtype=basic_p.dtype)
    return (u < basic_p).astype(basic_p.dtype)


def sample_top_probability(tree: CompiledTree, key, basic_p: jnp.ndarray,
                           n_trials: int,
                           house_states: jnp.ndarray | None = None):
    """Estimate the top-event probability by state simulation.

    Returns (estimate, states_of_top) so callers can compute CIs or
    accumulate across batches.
    """
    if house_states is None:
        house_states = jnp.asarray(tree.house_state_vector())
    states = sample_states(key, basic_p, n_trials)
    vals = propagate_probability(tree, states, house_states)
    top = vals[..., tree.top_index]
    return jnp.mean(top), top


def monte_carlo_ci(estimate, n_trials: int, z: float = 1.959963984540054):
    """Normal-approximation confidence half-width for a Bernoulli mean."""
    var = estimate * (1.0 - estimate) / n_trials
    return z * jnp.sqrt(var)
