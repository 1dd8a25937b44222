"""Grouped leaf deviates in the expression tape draw the same numbers as
one op at a time (same ``fold_in(key, slot)`` keys, vectorized)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.compiler.expr_tape import ExpressionTape
from canopy_tpu.mef.expr import ConstantExpression as C
from canopy_tpu.mef.expr.exponential import Exponential
from canopy_tpu.mef.expr.numerical import Mul
from canopy_tpu.mef.expr.random_deviate import (LognormalDeviate,
                                                NormalDeviate,
                                                UniformDeviate)
from canopy_tpu.mef.parameter import MissionTime


def _leaves(kind, n=7):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        m = float(rng.uniform(1e-4, 1e-2))
        if kind == "lognormal-ef":
            out.append(LognormalDeviate(C(m), C(3.0), C(0.95)))
        elif kind == "lognormal-mu":
            out.append(LognormalDeviate(C(np.log(m)), C(0.5)))
        elif kind == "normal":
            out.append(NormalDeviate(C(m), C(m / 10)))
        else:
            out.append(UniformDeviate(C(m / 2), C(2 * m)))
    return out


def _mixed():
    """Leaves, constants, a product over a deviate (not a leaf) and a
    mission-time dependent expression, interleaved."""
    mission = MissionTime()
    mission.set_value(100.0)
    shared = LognormalDeviate(C(1e-3), C(2.0), C(0.9))
    return (_leaves("lognormal-ef", 3) + [C(0.25), Mul([shared, C(2.0)]),
            shared, Exponential(C(1e-4), mission)] + _leaves("uniform", 2)
            + [C(0.5)])


CASES = {"lognormal-ef": lambda: _leaves("lognormal-ef"),
         "lognormal-mu": lambda: _leaves("lognormal-mu"),
         "normal": lambda: _leaves("normal"),
         "uniform": lambda: _leaves("uniform"),
         "mixed": _mixed,
         "constants": lambda: [C(0.1), C(0.2), C(0.3)]}


def _pair(name):
    exprs = CASES[name]()
    grouped = ExpressionTape.build(exprs)
    per_op = ExpressionTape.build(exprs)
    per_op._groups = []                      # Disable grouping.
    return grouped, per_op


@pytest.mark.parametrize("name", sorted(CASES))
def test_samples_identical(name):
    grouped, per_op = _pair(name)
    key = jax.random.PRNGKey(11)
    a = np.asarray(grouped.sample(key, 257, 100.0))
    b = np.asarray(per_op.sample(key, 257, 100.0))
    assert a.shape == b.shape == (257, grouped.n_outputs)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("times", [100.0, [10.0, 100.0, 1000.0]])
def test_means_identical(name, times):
    grouped, per_op = _pair(name)
    a = np.asarray(grouped.evaluate_mean(jnp.asarray(times)))
    b = np.asarray(per_op.evaluate_mean(jnp.asarray(times)))
    assert a.shape == np.shape(times) + (grouped.n_outputs,)
    np.testing.assert_array_equal(a, b)


def test_groups_cover_only_constant_argument_leaves():
    tape = ExpressionTape.build(_mixed())
    grouped = sum(len(g[2]) for g in tape._leaf_groups())
    assert grouped == 3 + 2 + 1     # Five leaves plus the shared deviate.
    kinds = {(g[0], g[1]) for g in tape._leaf_groups()}
    assert kinds == {("lognormal-deviate", "logarithmic"),
                     ("uniform-deviate", None)}


def test_lognormal_sample_statistics():
    """Means of the grouped lognormal draws match their arithmetic means."""
    exprs = [LognormalDeviate(C(m), C(3.0), C(0.95))
             for m in (1e-3, 5e-3, 2e-2)]
    tape = ExpressionTape.build(exprs)
    draws = np.asarray(tape.sample(jax.random.PRNGKey(0), 200_000, 1.0))
    np.testing.assert_allclose(draws.mean(axis=0), [1e-3, 5e-3, 2e-2],
                               rtol=0.03)
