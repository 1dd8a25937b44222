"""Epistemic uncertainty analysis: batched sampling + distribution stats.

The reference's Monte-Carlo uncertainty surface (``settings.h:118-175``:
num_trials, quantiles, bins) computed the SpMM way: the expression tape
draws ``num_trials`` probability vectors in one vectorized pass
(``compiler/expr_tape.py``), the whole batch propagates through the gate
graph at once (a (trials x basic) matrix against the gate structure — the
batched SpMM configuration of BASELINE.json config 2), and statistics
reduce on-device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import CompiledTree
from .propagate import make_propagator

__all__ = ["UncertaintyResult", "uncertainty_analysis", "sample_basic_probabilities"]


@dataclasses.dataclass
class UncertaintyResult:
    mean: float
    std: float
    error_factor: float          # p95 / median (lognormal-style EF).
    quantiles: np.ndarray        # (num_quantiles,) evenly spaced quantiles.
    histogram_edges: np.ndarray  # (num_bins + 1,)
    histogram_density: np.ndarray  # (num_bins,)
    n_trials: int

    def confidence_interval(self, level: float = 0.95) -> tuple[float, float]:
        lo = (1.0 - level) / 2.0
        qs = np.linspace(0.0, 1.0, len(self.quantiles))
        return (float(np.interp(lo, qs, self.quantiles)),
                float(np.interp(1.0 - lo, qs, self.quantiles)))


def sample_basic_probabilities(tape: ExpressionTape, key, n_trials: int,
                               mission_time: float,
                               clip_probability: bool = True) -> jnp.ndarray:
    """(n_trials, n_basic) sampled probability vectors from the tape."""
    samples = tape.sample(key, n_trials, mission_time)
    if clip_probability:
        samples = jnp.clip(samples, 0.0, 1.0)
    return samples


def uncertainty_analysis(tree: CompiledTree, tape: ExpressionTape, key,
                         n_trials: int, mission_time: float,
                         num_quantiles: int = 20, num_bins: int = 20,
                         house_states: jnp.ndarray | None = None,
                         batch_size: int | None = None,
                         top_fn=None) -> UncertaintyResult:
    """Distribution of the top-event probability under parameter uncertainty.

    ``batch_size`` splits the trials axis into chunks (checkpoint-friendly
    for very large sweeps); statistics are computed over the concatenated
    results. ``top_fn(p_batch) -> (trials,)`` overrides the evaluator
    (e.g. exact BDD evaluation).
    """
    if house_states is None:
        house_states = jnp.asarray(tree.house_state_vector())
    if top_fn is None:
        # The gather engine with the analysis' house states baked in.
        top_fn = make_propagator(tree, output="top",
                                 house_states=np.asarray(house_states))

    def run_batch(batch_key, batch_trials: int) -> jnp.ndarray:
        p = sample_basic_probabilities(tape, batch_key, batch_trials,
                                       mission_time)
        return top_fn(p)

    if batch_size is None or batch_size >= n_trials:
        tops = run_batch(key, n_trials)
    else:
        pieces = []
        remaining = n_trials
        batch_index = 0
        while remaining > 0:
            chunk = min(batch_size, remaining)
            pieces.append(run_batch(jax.random.fold_in(key, batch_index),
                                    chunk))
            remaining -= chunk
            batch_index += 1
        tops = jnp.concatenate(pieces)

    tops = np.asarray(tops)
    qs = np.linspace(0.0, 1.0, num_quantiles)
    quantiles = np.quantile(tops, qs)
    median = float(np.median(tops))
    p95 = float(np.quantile(tops, 0.95))
    hist, edges = np.histogram(tops, bins=num_bins, density=True)
    return UncertaintyResult(
        mean=float(tops.mean()), std=float(tops.std(ddof=1)),
        error_factor=(p95 / median if median > 0 else float("inf")),
        quantiles=quantiles, histogram_edges=edges, histogram_density=hist,
        n_trials=n_trials)
