"""Cross-engine consistency sweep: every quantification path must agree.

For randomized models: exact BDD == modular BDD == brute force; direct
propagation equals exact on module-free shared-free trees; rare-event and
MCUB bracket the exact value on coherent trees; bit-packed MC converges
to exact within its confidence interval; BDD cut sets equal MOCUS cut
sets (coherent case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.compiler.bdd import build_bdd
from canopy_tpu.compiler.cutsets import CutSetGenerator
from canopy_tpu.compiler.graph import compile_gates
from canopy_tpu.compiler.modules import build_modular_bdd, modular_probability
from canopy_tpu.compiler.zbdd import bdd_minimal_cut_sets
from canopy_tpu.engine.bdd_eval import bdd_probability
from canopy_tpu.engine.cutset_quantify import (build_cutset_matrix, mcub,
                                               product_probabilities,
                                               rare_event)
from canopy_tpu.engine.propagate import (mean_basic_probabilities,
                                         top_event_probability)
from canopy_tpu.ops.bitpack import packed_top_probability
from canopy_tpu.utils.synthetic import synthetic_mef_tree

from helpers import brute_force_probability

SEEDS = [101, 202, 303, 404, 505]


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    top, events = synthetic_mef_tree(
        n_basic=16, n_gates=14, fanin=3, seed=request.param,
        atleast_fraction=0.15, complement_fraction=0.05,
        p_range=(5e-3, 2e-1))
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    p = jnp.asarray(mean_basic_probabilities(tree))
    exact = brute_force_probability(top, events)
    return top, tree, p, exact


class TestCrossEngine:
    def test_bdd_equals_bruteforce(self, case):
        top, tree, p, exact = case
        got = float(bdd_probability(build_bdd(tree), p))
        assert got == pytest.approx(exact, abs=1e-13)

    def test_modular_equals_bruteforce(self, case):
        top, tree, p, exact = case
        got = float(modular_probability(build_modular_bdd(tree), p))
        assert got == pytest.approx(exact, abs=1e-12)

    def test_monte_carlo_converges(self, case):
        top, tree, p, exact = case
        n = 32 * 16384
        estimate = float(packed_top_probability(
            tree, jax.random.PRNGKey(1), p, n))
        stderr = max((exact * (1 - exact) / n) ** 0.5, 1e-6)
        assert abs(estimate - exact) < 6 * stderr

    def test_cutset_bounds_bracket_coherent(self, case):
        top, tree, p, exact = case
        generator = CutSetGenerator(tree, limit_order=16)
        products = generator.generate(top)
        coherent = all(not neg for prod in products for _s, neg in prod)
        if not coherent or generator.truncated:
            pytest.skip("non-coherent or truncated: bounds don't apply")
        matrix = build_cutset_matrix(products, tree.n_basic)
        q = product_probabilities(matrix, p)
        assert float(rare_event(q)) >= exact - 1e-12
        assert float(mcub(q)) >= exact - 1e-12

    def test_bdd_cuts_equal_mocus_coherent(self, case):
        top, tree, p, exact = case
        generator = CutSetGenerator(tree, limit_order=16)
        mocus = generator.generate(top)
        coherent = all(not neg for prod in mocus for _s, neg in prod)
        if not coherent or generator.truncated:
            pytest.skip("non-coherent or truncated")
        zbdd = bdd_minimal_cut_sets(build_bdd(tree), limit_order=16)
        assert set(zbdd) == set(mocus)

    def test_propagation_upper_sanity(self, case):
        """Direct propagation stays a probability and is deterministic."""
        top, tree, p, exact = case
        a = float(top_event_probability(tree, p))
        b = float(top_event_probability(tree, p))
        assert a == b
        assert 0.0 <= a <= 1.0


class TestBatchedEnginesAgainstBruteForce:
    """The jitted, trial-batched forms of the exact and direct engines
    against the brute-force oracle (every row of the batch is the same
    point, so each must reproduce the scalar answer)."""

    def test_bdd_evaluator_batch_equals_bruteforce(self, case):
        from canopy_tpu.engine.bdd_eval import make_bdd_evaluator
        top, tree, p, exact = case
        batch = jnp.broadcast_to(p, (1024, tree.n_basic))
        got = np.asarray(make_bdd_evaluator(build_bdd(tree))(batch))
        np.testing.assert_allclose(got, exact, rtol=1e-12, atol=1e-15)

    def test_propagator_batch_equals_single(self, case):
        from canopy_tpu.engine.propagate import make_propagator
        top, tree, p, exact = case
        batch = jnp.broadcast_to(jnp.asarray(p, jnp.float32),
                                 (1024, tree.n_basic))
        got = np.asarray(make_propagator(tree)(batch))
        want = np.asarray(top_event_probability(
            tree, batch, jnp.zeros(tree.n_house)), np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
