"""Propagation engine vs brute-force enumeration across all connectives."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.compiler.graph import compile_fault_tree, compile_gates
from canopy_tpu.engine.propagate import (mean_basic_probabilities,
                                         propagate_probability,
                                         top_event_probability)
from canopy_tpu.mef.event import (Arg, BasicEvent, Connective, Formula, Gate,
                                  HouseEvent)
from canopy_tpu.mef.expr import ConstantExpression

from helpers import brute_force_probability, build_model, eval_formula


def make_events(probs):
    events = []
    for i, p in enumerate(probs):
        e = BasicEvent(f"e{i}")
        e.expression = ConstantExpression(p)
        events.append(e)
    return events


def single_gate_tree(connective, probs, complements=None, min_number=None,
                     max_number=None):
    events = make_events(probs)
    complements = complements or [False] * len(events)
    gate = Gate("top")
    gate.formula = Formula(connective, [Arg(e, c)
                                        for e, c in zip(events, complements)],
                           min_number, max_number)
    return gate, events


def check_gate(gate, events, tol=1e-12):
    tree = compile_gates([gate])
    tree.top_index = tree.gate_index[gate.id]
    p = mean_basic_probabilities(tree)
    got = float(top_event_probability(tree, jnp.asarray(p)))
    expected = brute_force_probability(gate, events)
    assert abs(got - expected) < tol, (got, expected)


PROBS4 = [0.1, 0.25, 0.4, 0.7]


class TestConnectives:
    @pytest.mark.parametrize("conn", [Connective.AND, Connective.OR,
                                      Connective.NAND, Connective.NOR])
    def test_prod_family(self, conn):
        check_gate(*single_gate_tree(conn, PROBS4))

    @pytest.mark.parametrize("conn", [Connective.AND, Connective.OR])
    def test_with_complements(self, conn):
        check_gate(*single_gate_tree(conn, PROBS4,
                                     complements=[True, False, True, False]))

    @pytest.mark.parametrize("conn", [Connective.XOR, Connective.IFF,
                                      Connective.IMPLY])
    def test_pair_family(self, conn):
        check_gate(*single_gate_tree(conn, [0.3, 0.6]))

    @pytest.mark.parametrize("conn", [Connective.XOR, Connective.IFF,
                                      Connective.IMPLY])
    def test_pair_with_complements(self, conn):
        check_gate(*single_gate_tree(conn, [0.3, 0.6],
                                     complements=[True, False]))

    def test_not_null(self):
        check_gate(*single_gate_tree(Connective.NOT, [0.3]))
        check_gate(*single_gate_tree(Connective.NULL, [0.3]))

    @pytest.mark.parametrize("k", [2, 3])
    def test_atleast(self, k):
        check_gate(*single_gate_tree(Connective.ATLEAST, PROBS4,
                                     min_number=k))

    def test_atleast_with_complements(self):
        check_gate(*single_gate_tree(Connective.ATLEAST, PROBS4,
                                     complements=[True, False, False, True],
                                     min_number=2))

    @pytest.mark.parametrize("lo,hi", [(0, 2), (1, 3), (2, 2), (1, 4)])
    def test_cardinality(self, lo, hi):
        check_gate(*single_gate_tree(Connective.CARDINALITY, PROBS4,
                                     min_number=lo, max_number=hi))


class TestNestedTrees:
    def test_random_trees_vs_bruteforce(self):
        """Random nested trees (no repeated events) match enumeration."""
        rng = np.random.default_rng(12345)
        for trial in range(15):
            n_events = int(rng.integers(3, 9))
            events = make_events(rng.uniform(0.05, 0.95, n_events))
            pool = [Arg(e) for e in events]
            rng.shuffle(pool)
            gate_count = 0
            while len(pool) > 1:
                take = int(rng.integers(2, min(4, len(pool)) + 1))
                chosen, pool = pool[:take], pool[take:]
                conn = rng.choice([Connective.AND, Connective.OR,
                                   Connective.NAND, Connective.NOR])
                if take >= 3 and rng.random() < 0.3:
                    conn = Connective.ATLEAST
                    formula = Formula(conn, chosen, min_number=2)
                else:
                    formula = Formula(Connective(conn), chosen)
                gate = Gate(f"g{trial}_{gate_count}")
                gate_count += 1
                gate.formula = formula
                pool.append(Arg(gate, bool(rng.random() < 0.2)))
                rng.shuffle(pool)
            top = Gate("top")
            if isinstance(pool[0].event, Gate) and not pool[0].complement:
                top = pool[0].event
            else:
                top.formula = Formula(Connective.NULL, [Arg(pool[0].event)]) \
                    if not pool[0].complement else \
                    Formula(Connective.NOT, [Arg(pool[0].event)])
            check_gate(top, events, tol=1e-10)

    def test_house_events(self):
        model = build_model("""<?xml version="1.0"?>
<opsa-mef>
  <define-fault-tree name="FT">
    <define-gate name="top">
      <and><house-event name="h"/><basic-event name="e"/></and>
    </define-gate>
    <define-house-event name="h"><constant value="true"/></define-house-event>
    <define-basic-event name="e"><float value="0.5"/></define-basic-event>
  </define-fault-tree>
</opsa-mef>""")
        tree = compile_fault_tree(model.fault_trees.get("FT"))
        p = mean_basic_probabilities(tree)
        on = float(top_event_probability(tree, jnp.asarray(p)))
        assert abs(on - 0.5) < 1e-12
        # Flip the house state without recompiling.
        off = float(top_event_probability(
            tree, jnp.asarray(p), jnp.zeros(tree.n_house)))
        assert off == 0.0


class TestBatching:
    def test_trials_axis(self):
        gate, events = single_gate_tree(Connective.OR, PROBS4)
        tree = compile_gates([gate])
        tree.top_index = tree.gate_index[gate.id]
        batch = jnp.asarray(np.random.default_rng(0).uniform(
            0.0, 1.0, (64, 4)))
        out = top_event_probability(tree, batch)
        assert out.shape == (64,)
        # Spot-check one row against the scalar path.
        single = float(top_event_probability(tree, batch[7]))
        assert abs(float(out[7]) - single) < 1e-12

    def test_grad_is_birnbaum(self):
        """d(top)/d(p_i) equals P(top|x_i=1) - P(top|x_i=0)."""
        gate, events = single_gate_tree(Connective.OR, PROBS4)
        tree = compile_gates([gate])
        tree.top_index = tree.gate_index[gate.id]
        p = jnp.asarray(mean_basic_probabilities(tree))
        f = lambda q: top_event_probability(tree, q)  # noqa: E731
        g = jax.grad(f)(p)
        for i in range(4):
            p1 = p.at[i].set(1.0)
            p0 = p.at[i].set(0.0)
            mif = float(f(p1) - f(p0))
            assert abs(float(g[i]) - mif) < 1e-12


class TestStructure:
    def test_level_schedule(self):
        model = build_model("""<?xml version="1.0"?>
<opsa-mef>
  <define-fault-tree name="FT">
    <define-gate name="top"><and><gate name="m"/><gate name="n"/></and>
    </define-gate>
    <define-gate name="m"><or><basic-event name="a"/><basic-event name="b"/>
    </or></define-gate>
    <define-gate name="n"><and><gate name="m"/><basic-event name="c"/></and>
    </define-gate>
    <define-basic-event name="a"><float value="0.1"/></define-basic-event>
    <define-basic-event name="b"><float value="0.2"/></define-basic-event>
    <define-basic-event name="c"><float value="0.3"/></define-basic-event>
  </define-fault-tree>
</opsa-mef>""")
        tree = compile_fault_tree(model.fault_trees.get("FT"))
        assert tree.depth == 3  # m -> n -> top
        assert tree.n_basic == 3 and tree.n_gates == 3
        assert tree.nnz == 6

    def test_shared_subtree_counted_once(self):
        """Shared gates appear once in the schedule (DAG, not tree)."""
        a, b = make_events([0.2, 0.3])
        shared = Gate("shared")
        shared.formula = Formula(Connective.AND, [Arg(a), Arg(b)])
        g1 = Gate("g1")
        g1.formula = Formula(Connective.OR, [Arg(shared), Arg(a)])
        g2 = Gate("g2")
        g2.formula = Formula(Connective.OR, [Arg(shared), Arg(b)])
        top = Gate("top")
        top.formula = Formula(Connective.AND, [Arg(g1), Arg(g2)])
        tree = compile_gates([top])
        assert tree.n_gates == 4


class TestNarrowStorage:
    """bf16 value-matrix storage: compute stays >= f32, one rounding per
    level (the big-tree engine's memory ceiling is row bytes)."""

    def test_bf16_tracks_f32(self):
        import jax.numpy as jnp
        from canopy_tpu.engine.propagate import propagate_probability
        from canopy_tpu.utils.synthetic import synthetic_compiled_tree

        tree = synthetic_compiled_tree(n_basic=256, n_gates=1024, fanin=4,
                                       n_levels=6, seed=3)
        rng = np.random.default_rng(0)
        p = rng.uniform(0.0, 0.1, (32, tree.n_basic)).astype(np.float32)
        house = jnp.zeros(0)
        f32 = np.asarray(propagate_probability(tree, jnp.asarray(p), house))
        out = propagate_probability(tree, jnp.asarray(p, jnp.bfloat16),
                                    house)
        assert out.dtype == jnp.bfloat16
        b16 = np.asarray(out.astype(jnp.float32))
        # One bf16 rounding per level on values in [0, 1]: absolute
        # error stays ~depth * 2^-9.
        assert np.max(np.abs(b16 - f32)) < tree.depth * 2.0 ** -8

    def test_bf16_mixed_families(self):
        import jax.numpy as jnp
        from canopy_tpu.compiler.graph import compile_gates
        from canopy_tpu.engine.propagate import top_event_probability
        from canopy_tpu.mef.event import (Arg, BasicEvent, Connective,
                                          Formula, Gate)
        from canopy_tpu.mef.expr import ConstantExpression

        events = []
        for i in range(5):
            e = BasicEvent(f"nb{i}")
            e.expression = ConstantExpression(0.2)
            events.append(e)
        g1 = Gate("g1")
        g1.formula = Formula(Connective.ATLEAST,
                             [Arg(e) for e in events[:4]], min_number=2)
        g2 = Gate("g2")
        g2.formula = Formula(Connective.XOR, [Arg(g1), Arg(events[4])])
        top = Gate("topn")
        top.formula = Formula(Connective.OR, [Arg(g1), Arg(g2, True)])
        tree = compile_gates([top])
        tree.top_index = tree.gate_index["topn"]
        rng = np.random.default_rng(1)
        p = rng.uniform(0.0, 0.9, (16, 5)).astype(np.float32)
        f32 = np.asarray(top_event_probability(tree, jnp.asarray(p)))
        b16 = np.asarray(top_event_probability(
            tree, jnp.asarray(p, jnp.bfloat16)).astype(jnp.float32))
        np.testing.assert_allclose(b16, f32, atol=0.02)


class TestParamPropagator:
    """make_param_propagator: index arrays as traced arguments —
    bit-identical to the gather engine."""

    def test_bit_identical_to_gather(self):
        import jax
        from canopy_tpu.engine.propagate import (make_param_propagator,
                                                 top_event_probability)
        from canopy_tpu.utils.synthetic import synthetic_compiled_tree
        tree = synthetic_compiled_tree(n_basic=128, n_gates=400, fanin=4,
                                       n_levels=6, seed=21)
        fn, params = make_param_propagator(tree)
        rng = np.random.default_rng(0)
        basic = jnp.asarray(rng.uniform(0, 1, (64, tree.n_basic)),
                            jnp.float32)
        house = jnp.asarray(tree.house_state_vector(), jnp.float32)
        got = jax.jit(fn)(params, basic, house)
        want = top_event_probability(tree, basic, house)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(want, np.float32))

    def test_mixed_families_and_house(self):
        import jax
        from helpers import mixed_tree
        from canopy_tpu.engine.propagate import (make_param_propagator,
                                                 top_event_probability)
        tree = mixed_tree()
        fn, params = make_param_propagator(tree)
        rng = np.random.default_rng(5)
        basic = jnp.asarray(rng.uniform(0, 1, (8, tree.n_basic)))
        house = jnp.asarray(tree.house_state_vector())
        got = jax.jit(fn)(params, basic, house)
        want = top_event_probability(tree, basic, house)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=0)


class TestTopConePruning:
    def test_prune_is_bit_exact_and_smaller(self):
        from canopy_tpu.compiler.graph import prune_to_top_cone
        from canopy_tpu.utils.synthetic import synthetic_compiled_tree
        tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                       n_levels=8, seed=0)
        pruned = prune_to_top_cone(tree)
        assert pruned.n_gates < tree.n_gates
        assert pruned.n_basic == tree.n_basic
        # Contiguity invariant: every block's outputs stay consecutive.
        for level in pruned.levels:
            for _k, b in level.iter_blocks():
                d = np.diff(np.asarray(b.out_idx))
                assert (d == 1).all() or len(d) == 0
        rng = np.random.default_rng(3)
        p = jnp.asarray(rng.uniform(0.0, 0.5, (128, tree.n_basic)),
                        jnp.float32)
        a = np.asarray(top_event_probability(tree, p))
        b = np.asarray(top_event_probability(pruned, p))
        assert np.array_equal(a, b)

    def test_make_propagator_gather_top_uses_cone(self):
        from canopy_tpu.engine.propagate import make_propagator
        from canopy_tpu.utils.synthetic import synthetic_compiled_tree
        tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                       n_levels=8, seed=1)
        fn = make_propagator(tree, engine="gather", output="top")
        rng = np.random.default_rng(4)
        p = jnp.asarray(rng.uniform(0.0, 0.5, (64, tree.n_basic)),
                        jnp.float32)
        got = np.asarray(fn(p))
        want = np.asarray(top_event_probability(
            tree, p, jnp.asarray(tree.house_state_vector())))
        assert np.array_equal(got, want)


class TestStagedPropagator:
    def test_gather_fallback_identity_stage(self):
        # The pair is (identity, pruned-cone gather) and matches the full
        # evaluation.
        from canopy_tpu.engine.propagate import make_staged_propagator
        from canopy_tpu.utils.synthetic import synthetic_compiled_tree
        tree = synthetic_compiled_tree(n_basic=96, n_gates=600, fanin=4,
                                       n_levels=8, seed=2)
        stage, run = make_staged_propagator(tree)
        rng = np.random.default_rng(8)
        p = jnp.asarray(rng.uniform(0.0, 0.5, (32, tree.n_basic)),
                        jnp.float32)
        got = np.asarray(run(stage(p)))
        want = np.asarray(top_event_probability(
            tree, p, jnp.asarray(tree.house_state_vector())))
        # jit may FMA-contract the prod chains differently from the
        # eager reference: last-ulp tolerance.
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
