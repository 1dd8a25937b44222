"""Exact probability evaluation over a level-scheduled ROBDD.

Shannon recursion as batched device compute: per level, one gather of
child values + one fused multiply-add per node —

    P(node) = p[var] * P(high) + (1 - p[var]) * P(low)

with terminals pinned to 0/1. Exact for any DAG (shared events included),
batched over a trials axis for exact epistemic uncertainty, and
`grad`-able for exact Birnbaum importances (the top probability is
multilinear in p, so reverse-mode through this evaluator *is* the exact
partial-derivative vector).  A BDD runs as a one-module
:class:`~canopy_tpu.compiler.bdd.FusedChain`, the program the modular
chain runs too.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..compiler.bdd import CompiledBdd, fused_probability

__all__ = ["bdd_probability", "make_bdd_evaluator"]


def bdd_probability(bdd: CompiledBdd, basic_p: jnp.ndarray) -> jnp.ndarray:
    """Top-event probability; ``basic_p``: (..., n_basic); returns (...)."""
    return fused_probability(bdd.fused(), basic_p)


def make_bdd_evaluator(bdd: CompiledBdd):
    """A jitted exact evaluator ``f(basic_p) -> top probability``
    (one compilation per input shape)."""
    return jax.jit(functools.partial(bdd_probability, bdd))
