"""Importance analysis via automatic differentiation.

The importance surface of the reference Settings
(``settings.h:262-278``), computed by automatic differentiation: because the
propagated top-event probability is *multilinear* in each basic-event
probability, the Birnbaum marginal importance factor

    MIF_i = dP(top)/dp_i = P(top | x_i=1) - P(top | x_i=0)

is exact, and one reverse-mode pass through the propagation engine yields
every event's MIF at once — replacing the classical 2N+1 re-evaluations.
All other measures derive algebraically from (P, p, MIF):

    P(top | x_i=1) = P + (1 - p_i) * MIF_i
    P(top | x_i=0) = P - p_i * MIF_i
    CIF_i = p_i * MIF_i / P            (criticality)
    DIF_i = p_i * P(top|x_i=1) / P     (diagnosis / Fussell-Vesely-style)
    RAW_i = P(top|x_i=1) / P           (risk achievement worth)
    RRW_i = P / P(top|x_i=0)           (risk reduction worth)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.graph import CompiledTree
from .propagate import top_event_probability

__all__ = ["ImportanceResult", "importance_measures", "occurrence_counts"]


@dataclasses.dataclass
class ImportanceResult:
    """Per-basic-event importance measures (arrays indexed by basic slot)."""

    top_probability: float
    mif: np.ndarray
    cif: np.ndarray
    dif: np.ndarray
    raw: np.ndarray
    rrw: np.ndarray
    occurrences: np.ndarray | None = None

    def as_table(self, tree: CompiledTree) -> list[dict]:
        rows = []
        for event_id, slot in tree.basic_index.items():
            row = {"event": event_id,
                   "MIF": float(self.mif[slot]),
                   "CIF": float(self.cif[slot]),
                   "DIF": float(self.dif[slot]),
                   "RAW": float(self.raw[slot]),
                   "RRW": float(self.rrw[slot])}
            if self.occurrences is not None:
                row["occurrence"] = int(self.occurrences[slot])
            rows.append(row)
        return rows


def importance_measures(tree: CompiledTree, basic_p: jnp.ndarray,
                        house_states: jnp.ndarray | None = None,
                        top_fn=None) -> ImportanceResult:
    """All importance measures from one forward + one backward pass.

    ``top_fn(p) -> P(top)`` overrides the evaluator (e.g. the exact BDD
    evaluator); default is direct propagation.
    """
    if house_states is None:
        house_states = jnp.asarray(tree.house_state_vector())

    def top(p):
        if top_fn is not None:
            return top_fn(p)
        return top_event_probability(tree, p, house_states)

    p_top, mif = jax.value_and_grad(top)(jnp.asarray(basic_p))
    p = jnp.asarray(basic_p)
    p_one = p_top + (1.0 - p) * mif
    p_zero = p_top - p * mif
    safe_top = jnp.where(p_top > 0, p_top, 1.0)
    cif = jnp.where(p_top > 0, p * mif / safe_top, 0.0)
    dif = jnp.where(p_top > 0, p * p_one / safe_top, 0.0)
    raw = jnp.where(p_top > 0, p_one / safe_top, 0.0)
    safe_zero = jnp.where(p_zero > 0, p_zero, 1.0)
    rrw = jnp.where(p_zero > 0, p_top / safe_zero, jnp.inf)
    return ImportanceResult(
        top_probability=float(p_top),
        mif=np.asarray(mif), cif=np.asarray(cif), dif=np.asarray(dif),
        raw=np.asarray(raw), rrw=np.asarray(rrw))


def occurrence_counts(products, n_basic: int) -> np.ndarray:
    """How many minimal products each basic event appears in."""
    counts = np.zeros(n_basic, dtype=np.int64)
    for product in products:
        for slot, _neg in product:
            counts[slot] += 1
    return counts
