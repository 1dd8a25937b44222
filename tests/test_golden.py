"""Golden-model regression tests (SURVEY.md §4.2): full-stack XML ->
model -> compile -> quantify against frozen reference values."""

import json
import os

import jax
import jax.numpy as jnp
import pytest

from canopy_tpu.compiler.bdd import build_bdd
from canopy_tpu.compiler.cutsets import CutSetGenerator
from canopy_tpu.compiler.graph import compile_fault_tree
from canopy_tpu.engine.bdd_eval import bdd_probability
from canopy_tpu.engine.cutset_quantify import (build_cutset_matrix, mcub,
                                               product_probabilities,
                                               rare_event)
from canopy_tpu.engine.propagate import mean_basic_probabilities
from canopy_tpu.mef import Initializer
from canopy_tpu.ops.bitpack import packed_top_probability
from canopy_tpu.settings import Settings

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

with open(os.path.join(FIXTURES, "golden.json")) as fh:
    GOLDEN = json.load(fh)


FT_CASES = sorted(n for n, g in GOLDEN.items()
                  if g.get("kind", "fault_tree") == "fault_tree")


@pytest.fixture(scope="module", params=FT_CASES)
def case(request):
    name = request.param
    path = os.path.join(FIXTURES, f"{name}.xml")
    settings = Settings().probability_analysis(True).ccf_analysis(True)
    model = Initializer([path], settings).model
    tree = compile_fault_tree(model.fault_trees.get(name))
    return name, GOLDEN[name], tree


class TestGolden:
    def test_structure(self, case):
        name, golden, tree = case
        assert tree.n_basic == golden["n_basic"]
        assert tree.n_gates == golden["n_gates"]
        assert tree.nnz == golden["nnz"]

    def test_bdd_exact(self, case):
        name, golden, tree = case
        p = jnp.asarray(mean_basic_probabilities(tree))
        if golden.get("modular"):
            from canopy_tpu.compiler.modules import (build_modular_bdd,
                                                     modular_probability)
            mb = build_modular_bdd(tree)
            assert sum(b.n_nodes for b, _s in mb.chain) \
                == golden["bdd_nodes"]
            got = float(modular_probability(mb, p))
        else:
            bdd = build_bdd(tree, max_nodes=golden.get("bdd_max_nodes",
                                                       2_000_000))
            assert bdd.n_nodes == golden["bdd_nodes"]
            got = float(bdd_probability(bdd, p))
        assert abs(got - golden["exact_probability"]) < 1e-10

    def test_cutset_bounds(self, case):
        name, golden, tree = case
        if not golden.get("coherent", True) \
                or not golden.get("cutset_check", True):
            pytest.skip("bounds only bracket (nearly) coherent, "
                        "untruncated models")
        exact = golden["exact_probability"]
        top = next(g for g in tree.gates
                   if tree.gate_index[g.id] == tree.top_index)
        generator = CutSetGenerator(tree, limit_order=8)
        products = generator.generate(top)
        matrix = build_cutset_matrix(products, tree.n_basic)
        p = jnp.asarray(mean_basic_probabilities(tree))
        q = product_probabilities(matrix, p)
        mcub_val = float(mcub(q))
        re_val = float(rare_event(q))
        # For these (nearly) coherent models the bounds bracket tightly.
        assert re_val >= exact * 0.98
        assert abs(mcub_val - exact) / exact < 0.05

    def test_monte_carlo_agrees(self, case):
        name, golden, tree = case
        p = jnp.asarray(mean_basic_probabilities(tree))
        estimate = float(packed_top_probability(
            tree, jax.random.PRNGKey(11), p, 32 * 8192))
        exact = golden["exact_probability"]
        stderr = (exact * (1 - exact) / (32 * 8192)) ** 0.5
        assert abs(estimate - exact) < 6 * stderr + 1e-4


class TestNestedCountAnchor:
    """The deep atleast/cardinality nesting anchor (the hardest
    vectorization case, SURVEY.md §4.2): beyond the generic BDD/MC
    coverage every fault-tree golden gets, drive the jitted f32 gather
    engine's Poisson-binomial count DP against the f64 evaluation, and
    pin the structural claims
    (nesting depth, count-gate share) the anchor exists to cover."""

    NAME = "aralia_like_nested_count"

    @pytest.fixture(scope="class")
    def nested(self):
        path = os.path.join(FIXTURES, f"{self.NAME}.xml")
        settings = Settings().probability_analysis(True)
        model = Initializer([path], settings).model
        tree = compile_fault_tree(model.fault_trees.get(self.NAME))
        return GOLDEN[self.NAME], tree

    def test_structural_claims(self, nested):
        golden, tree = nested
        assert golden["count_nesting_depth"] >= 20
        assert golden["count_gates"] >= 300
        # Extreme sharing: direct propagation must NOT match the exact
        # value (otherwise the anchor fails to exercise the exact
        # ladder) — the BDD and the 2^22 enumeration agree instead.
        assert abs(golden["brute_force_probability"]
                   - golden["exact_probability"]) < 1e-9
        from canopy_tpu.mef.event import Connective
        n_count = sum(
            1 for g in tree.gates
            if g.formula.connective in (Connective.ATLEAST,
                                        Connective.CARDINALITY))
        assert n_count == golden["count_gates"]

    def test_gather_engine_count_dp(self, nested):
        """The jitted gather engine's Poisson-binomial count DP in f32
        tracks the f64 evaluation on the fan-in-86 vote; direct
        propagation stays inside the sanity band of the exact value."""
        import numpy as np
        import jax.numpy as jnp
        from canopy_tpu.engine.propagate import (make_propagator,
                                                 top_event_probability)

        golden, tree = nested
        bp = mean_basic_probabilities(tree)
        house = jnp.asarray(tree.house_state_vector())
        got = float(make_propagator(tree)(
            jnp.asarray(bp[None, :], jnp.float32))[0])
        ref = float(top_event_probability(tree, jnp.asarray(bp), house))
        assert got == pytest.approx(ref, rel=1e-5)
        # Direct propagation is approximate on shared events — the
        # anchor's exact value comes from the BDD; sanity-band only.
        assert abs(got - golden["exact_probability"]) \
            < 0.5 * max(golden["exact_probability"], 1e-12) + 1e-9


class TestHandEventTree:
    """Hand-computed event-tree anchor (see the derivation comment in
    tests/fixtures/hand_event_tree.xml and golden.json)."""

    def test_sequence_probabilities(self):
        from canopy_tpu.engine.analysis import RiskAnalysis
        golden = GOLDEN["hand_event_tree"]
        path = os.path.join(FIXTURES, "hand_event_tree.xml")
        settings = Settings().probability_analysis(True)
        model = Initializer([path], settings).model
        report = RiskAnalysis(model, settings).run()
        by_name = {s.sequence: s for s in report.sequences}
        assert set(by_name) == set(golden["sequences"])
        for seq, want in golden["sequences"].items():
            assert abs(by_name[seq].probability - want) < 1e-12, seq


class TestGoldenSubstitution:
    """Substitution-bearing anchor: hand-derived product set and
    closed-form probability through the full analysis stack."""

    def test_products_and_probability(self):
        from canopy_tpu.engine.analysis import RiskAnalysis
        golden = GOLDEN["aralia_like_substitution"]
        path = os.path.join(FIXTURES, "aralia_like_substitution.xml")
        settings = Settings().probability_analysis(True)
        model = Initializer([path], settings).model
        report = RiskAnalysis(model, settings).run()
        res = report.fault_trees[0]
        assert abs(res.probability - golden["exact_probability"]) < 1e-12
        assert res.n_products == golden["n_products_after_substitution"]
        got = sorted(sorted(names) for _o, _q, names in res.products)
        assert got == golden["products_after_substitution"]


class TestGoldenAlignment:
    """Alignment-bearing anchor: closed-form per-phase probabilities
    through the batched phase analysis."""

    def test_phase_probabilities(self):
        from canopy_tpu.engine.analysis import RiskAnalysis
        golden = GOLDEN["aralia_like_alignment"]
        path = os.path.join(FIXTURES, "aralia_like_alignment.xml")
        settings = Settings().probability_analysis(True)
        model = Initializer([path], settings).model
        report = RiskAnalysis(model, settings).run()
        phases = {r.phase: r.probability for r in report.fault_trees
                  if r.alignment == "duty"}
        assert set(phases) == set(golden["phases"])
        for name, want in golden["phases"].items():
            assert abs(phases[name] - want) < 1e-12


class TestGoldenPlant:
    """Plant-scale anchor: the 9,363-gate hierarchical tree's top
    probability, modular-BDD exact vs the frozen value (itself
    cross-checked against a recorded 1e7-trial bit-packed MC run)."""

    def test_modular_bdd_matches_frozen(self):
        import numpy as np
        from canopy_tpu.compiler.modules import (build_modular_bdd,
                                                 modular_probability)
        from canopy_tpu.utils.synthetic import synthetic_hierarchical_tree
        golden = GOLDEN["plant_hier_9363"]
        tree = synthetic_hierarchical_tree(**golden["generator"])
        assert tree.n_gates == golden["n_gates"]
        assert tree.nnz == golden["nnz"]
        p = jnp.asarray(np.random.default_rng(42).uniform(
            1e-4, 5e-3, tree.n_basic))
        mb = build_modular_bdd(tree, max_nodes=50_000_000)
        assert len(mb.chain) == golden["modules"]
        assert mb.total_nodes == golden["bdd_nodes"]
        got = float(modular_probability(mb, p))
        assert abs(got - golden["exact_probability"]) < 1e-10
        # The frozen value sits inside the recorded MC 4-sigma band.
        assert abs(golden["mc_estimate"] - got) < golden["mc_4sigma"]
