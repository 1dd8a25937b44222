"""Sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.compiler.cutsets import CutSetGenerator
from canopy_tpu.compiler.graph import compile_gates
from canopy_tpu.engine.cutset_quantify import (build_cutset_matrix, mcub,
                                               product_probabilities,
                                               rare_event)
from canopy_tpu.engine.propagate import (mean_basic_probabilities,
                                         top_event_probability)
from canopy_tpu.mef.event import Arg, BasicEvent, Connective, Formula, Gate
from canopy_tpu.mef.expr import ConstantExpression
from canopy_tpu.parallel.mesh import make_mesh, mesh_shape
from canopy_tpu.parallel.quantify import (sharded_cutset_quantifier,
                                          sharded_uncertainty_step)


def build_tree(n_groups=8):
    events = []
    group_gates = []
    for g in range(n_groups):
        group = []
        for i in range(3):
            e = BasicEvent(f"e{g}_{i}")
            e.expression = ConstantExpression(0.01 * (g + 1) + 0.001 * i)
            events.append(e)
            group.append(e)
        gate = Gate(f"g{g}")
        gate.formula = Formula(Connective.AND, [Arg(e) for e in group])
        group_gates.append(gate)
    top = Gate("top")
    top.formula = Formula(Connective.OR, [Arg(g) for g in group_gates])
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree, top


class TestMesh:
    def test_mesh_shape(self):
        assert mesh_shape(8) == (4, 2)
        assert mesh_shape(8, model_parallelism=4) == (2, 4)
        assert mesh_shape(1) == (1, 1)
        with pytest.raises(ValueError):
            mesh_shape(8, model_parallelism=3)

    def test_make_mesh(self):
        mesh = make_mesh()
        assert mesh.devices.size == 8
        assert set(mesh.axis_names) == {"data", "model"}


class TestShardedUncertainty:
    def test_matches_single_device(self):
        tree, _ = build_tree()
        mesh = make_mesh()
        step = sharded_uncertainty_step(tree, mesh)
        batch = jnp.asarray(np.random.default_rng(0).uniform(
            0, 0.2, (64, tree.n_basic)))
        house = jnp.zeros(tree.n_house)
        got = step(batch, house)
        expected = top_event_probability(tree, batch)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                                   rtol=1e-12)


class TestShardedCutsets:
    def test_matches_single_device(self):
        tree, top = build_tree()
        products = CutSetGenerator(tree).generate(top)
        matrix = build_cutset_matrix(products, tree.n_basic)
        mesh = make_mesh()
        quantify = sharded_cutset_quantifier(matrix, mesh)
        batch = jnp.asarray(np.random.default_rng(1).uniform(
            0, 0.2, (32, tree.n_basic)))
        re_got, mcub_got = quantify(batch)
        q = product_probabilities(matrix, batch)
        np.testing.assert_allclose(np.asarray(re_got),
                                   np.asarray(rare_event(q)), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(mcub_got),
                                   np.asarray(mcub(q)), rtol=1e-12)

    def test_row_count_not_divisible(self):
        """Padding rows must not change the result."""
        tree, top = build_tree(n_groups=5)  # 5 products, model axis = 2.
        products = CutSetGenerator(tree).generate(top)
        assert len(products) == 5
        matrix = build_cutset_matrix(products, tree.n_basic)
        mesh = make_mesh()
        quantify = sharded_cutset_quantifier(matrix, mesh)
        batch = jnp.asarray(np.random.default_rng(2).uniform(
            0, 0.3, (8, tree.n_basic)))
        re_got, _ = quantify(batch)
        q = product_probabilities(matrix, batch)
        np.testing.assert_allclose(np.asarray(re_got),
                                   np.asarray(rare_event(q)), rtol=1e-12)


class TestDeterminism:
    def test_same_seed_same_result_any_layout(self):
        """Same seed -> identical sampled states regardless of sharding."""
        from canopy_tpu.engine.sampler import sample_states
        tree, _ = build_tree()
        p = jnp.asarray(mean_basic_probabilities(tree))
        key = jax.random.PRNGKey(42)
        a = sample_states(key, p, 256)
        b = sample_states(key, p, 256)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
