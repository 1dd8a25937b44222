"""The XLA engines on the semantics the removed Pallas engines covered.

House states, off-grid and multi-tile trial counts, xor/iff/count gates,
shared events, float32/bfloat16 storage, the exact BDD and modular
evaluators, gradients and importance — each checked against a reference
that shares no code with the engine under test: the numpy gate-by-gate
propagation and brute-force enumeration in ``tests/helpers.py``, an
independently built monolithic BDD, or central finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.compiler.bdd import build_bdd
from canopy_tpu.compiler.graph import (CompiledTree, LevelBlock, ProdBlock,
                                       _emit_gate_ops, compile_gates,
                                       prune_to_top_cone)
from canopy_tpu.compiler.modules import build_modular_bdd, modular_probability
from canopy_tpu.engine.bdd_eval import bdd_probability, make_bdd_evaluator
from canopy_tpu.engine.importance import importance_measures
from canopy_tpu.engine.propagate import (ENGINES, make_param_propagator,
                                         make_propagator,
                                         make_staged_propagator,
                                         mean_basic_probabilities)
from canopy_tpu.errors import LogicError
from canopy_tpu.ops import bitpack
from canopy_tpu.ops.bitpack import packed_top_probability
from canopy_tpu.utils.synthetic import (synthetic_compiled_tree,
                                        synthetic_hierarchical_tree,
                                        synthetic_mef_tree)

from helpers import brute_force_probability, mixed_tree, numpy_propagate


def _mef(seed, n_basic=48, n_gates=36, **kw):
    top, events = synthetic_mef_tree(n_basic=n_basic, n_gates=n_gates,
                                     fanin=3, seed=seed, **kw)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    return tree, top, events


#: The tree generators the kernel engines were tested on.
TREES = {
    "mixed-house": lambda: mixed_tree(n_house=1),
    "mixed-no-house": lambda: mixed_tree(n_house=0),
    "uniform-prod": lambda: synthetic_compiled_tree(
        n_basic=256, n_gates=512, fanin=4, n_levels=6, seed=0),
    "uniform-deep": lambda: synthetic_compiled_tree(
        n_basic=96, n_gates=900, fanin=4, n_levels=10, seed=7),
    "uniform-shallow": lambda: synthetic_compiled_tree(
        n_basic=64, n_gates=128, fanin=3, n_levels=4, seed=2),
    "mef-shared": lambda: _mef(5)[0],
    "mef-counts": lambda: _mef(13, n_basic=30, n_gates=22,
                               atleast_fraction=0.3)[0],
    "hierarchical": lambda: synthetic_hierarchical_tree(
        n_basic=512, branching=4, share_fraction=0.1, n_shared=16, seed=1),
}
_CACHE: dict = {}


def tree_of(name):
    if name not in _CACHE:
        _CACHE[name] = TREES[name]()
    return _CACHE[name]


def batch_of(tree, n_trials, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0,
                                               (n_trials, tree.n_basic))


class TestGatherEngine:
    @pytest.mark.parametrize("name", sorted(TREES))
    @pytest.mark.parametrize("n_trials", [1, 100, 1024, 3072])
    def test_top_matches_numpy_reference(self, name, n_trials):
        """Single, off-grid and multi-tile trial counts in float64."""
        tree = tree_of(name)
        p = batch_of(tree, n_trials, seed=n_trials)
        got = np.asarray(make_propagator(tree)(jnp.asarray(p)))
        want = numpy_propagate(tree, p)[:, tree.top_index]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_float32_tracks_reference(self, name):
        tree = tree_of(name)
        p = batch_of(tree, 1024, seed=3)
        got = np.asarray(make_propagator(tree)(jnp.asarray(p, jnp.float32)))
        want = numpy_propagate(tree, p)[:, tree.top_index]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_bfloat16_storage(self, name):
        """Storage rounds once per level; compute stays float32."""
        tree = tree_of(name)
        p = batch_of(tree, 64, seed=4) * 0.1
        out = make_propagator(tree, output="all")(jnp.asarray(p,
                                                              jnp.bfloat16))
        assert out.dtype == jnp.bfloat16
        want = numpy_propagate(tree, p)
        err = np.max(np.abs(np.asarray(out.astype(jnp.float32)) - want))
        assert err < (tree.depth + 1) * 2.0 ** -7

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_all_output_matches_reference(self, name):
        tree = tree_of(name)
        p = batch_of(tree, 16, seed=5)
        got = np.asarray(make_propagator(tree, output="all")(jnp.asarray(p)))
        np.testing.assert_allclose(got, numpy_propagate(tree, p),
                                   rtol=1e-12, atol=1e-15)

    @pytest.mark.parametrize("state", [0.0, 1.0])
    @pytest.mark.parametrize("how", ["per-call", "baked"])
    def test_house_states(self, state, how):
        tree = tree_of("mixed-house")
        p = batch_of(tree, 100, seed=6)
        house = np.asarray([state])
        if how == "baked":
            got = make_propagator(tree, house_states=house)(jnp.asarray(p))
        else:
            got = make_propagator(tree)(jnp.asarray(p), jnp.asarray(house))
        want = numpy_propagate(tree, p, house)[:, tree.top_index]
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)

    @pytest.mark.parametrize("engine", ["stream", "replay", "spill", "block",
                                        "fused", "bdd-stream", "tiled", ""])
    def test_removed_engines_rejected(self, engine):
        with pytest.raises(ValueError, match="unknown propagation engine"):
            make_propagator(tree_of("mixed-house"), engine=engine)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_known_engines_agree(self, engine):
        tree = tree_of("uniform-deep")
        p = jnp.asarray(batch_of(tree, 32, seed=7))
        a = make_propagator(tree, engine=engine)(p)
        b = make_propagator(tree, engine="gather")(p)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("name", ["mixed-house", "uniform-deep",
                                      "mef-counts", "hierarchical"])
    def test_staged_pair_is_identity_plus_gather(self, name):
        tree = tree_of(name)
        stage, run = make_staged_propagator(tree)
        p = jnp.asarray(batch_of(tree, 64, seed=8))
        np.testing.assert_array_equal(np.asarray(stage(p)), np.asarray(p))
        want = numpy_propagate(tree, np.asarray(p))[:, tree.top_index]
        np.testing.assert_allclose(np.asarray(run(stage(p))), want,
                                   rtol=1e-12, atol=1e-15)

    @pytest.mark.parametrize("name", ["mixed-house", "uniform-prod",
                                      "mef-counts", "hierarchical"])
    def test_param_propagator_matches_reference(self, name):
        tree = tree_of(name)
        fn, params = make_param_propagator(tree)
        p = batch_of(tree, 32, seed=9)
        got = jax.jit(fn)(params, jnp.asarray(p),
                          jnp.asarray(tree.house_state_vector()))
        want = numpy_propagate(tree, p)[:, tree.top_index]
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                                   atol=1e-15)

    @pytest.mark.parametrize("name", ["mixed-house", "uniform-deep",
                                      "mef-shared", "mef-counts"])
    def test_grad_matches_central_differences(self, name):
        """Direct propagation is a polynomial in each p_i; central
        differences with a small step recover its derivative."""
        tree = tree_of(name)
        p0 = batch_of(tree, 1, seed=10)[0] * 0.5 + 0.25
        fn = make_propagator(tree)
        grad = np.asarray(jax.grad(lambda q: fn(q[None, :])[0])(
            jnp.asarray(p0)))
        h = 1e-5
        for i in range(0, tree.n_basic, max(tree.n_basic // 6, 1)):
            up, dn = p0.copy(), p0.copy()
            up[i] += h
            dn[i] -= h
            fd = (numpy_propagate(tree, up)[0, tree.top_index]
                  - numpy_propagate(tree, dn)[0, tree.top_index]) / (2 * h)
            assert abs(grad[i] - fd) <= 1e-7 + 1e-6 * abs(fd), i


def _small_mef(seed):
    return _mef(seed, n_basic=11, n_gates=10, atleast_fraction=0.2,
                complement_fraction=0.1, p_range=(0.02, 0.4))


SMALL_SEEDS = [3, 17, 29, 41, 53]


class TestExactEvaluators:
    @pytest.mark.parametrize("seed", SMALL_SEEDS)
    def test_bdd_evaluator_vs_bruteforce(self, seed):
        tree, top, events = _small_mef(seed)
        p = jnp.asarray(mean_basic_probabilities(tree))
        want = brute_force_probability(top, events)
        fn = make_bdd_evaluator(build_bdd(tree))
        assert float(fn(p)) == pytest.approx(want, abs=1e-13)
        batch = jnp.broadcast_to(p, (100, tree.n_basic))
        np.testing.assert_allclose(np.asarray(fn(batch)), want, atol=1e-13)

    @pytest.mark.parametrize("seed", SMALL_SEEDS)
    def test_modular_vs_bruteforce(self, seed):
        tree, top, events = _small_mef(seed)
        p = jnp.asarray(mean_basic_probabilities(tree))
        got = float(modular_probability(build_modular_bdd(tree), p))
        assert got == pytest.approx(brute_force_probability(top, events),
                                    abs=1e-13)

    @pytest.mark.parametrize("name", ["mixed-house", "mixed-no-house",
                                      "mef-shared", "mef-counts",
                                      "hierarchical"])
    @pytest.mark.parametrize("n_trials", [1, 100, 1024])
    def test_modular_vs_monolithic_bdd(self, name, n_trials):
        """The fused module chain against one independently built BDD."""
        tree = tree_of(name)
        p = jnp.asarray(batch_of(tree, n_trials, seed=11))
        modular = build_modular_bdd(tree)
        got = np.asarray(jax.jit(
            lambda q: modular_probability(modular, q))(p))
        want = np.asarray(bdd_probability(build_bdd(tree), p))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)

    @pytest.mark.parametrize("name", ["mixed-house", "mef-counts",
                                      "hierarchical"])
    def test_modular_float32(self, name):
        tree = tree_of(name)
        p = batch_of(tree, 1024, seed=12)
        modular = build_modular_bdd(tree)
        got = np.asarray(modular_probability(modular,
                                             jnp.asarray(p, jnp.float32)))
        want = np.asarray(bdd_probability(build_bdd(tree), jnp.asarray(p)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    def test_modular_batch_shapes(self):
        tree = tree_of("mef-shared")
        modular = build_modular_bdd(tree)
        p = jnp.asarray(batch_of(tree, 12, seed=13)).reshape(
            3, 4, tree.n_basic)
        out = modular_probability(modular, p)
        assert out.shape == (3, 4)
        flat = modular_probability(modular, p.reshape(12, tree.n_basic))
        np.testing.assert_array_equal(np.asarray(out).reshape(-1),
                                      np.asarray(flat))

    @pytest.mark.parametrize("seed", SMALL_SEEDS)
    def test_modular_grad_is_birnbaum(self, seed):
        """The exact top is multilinear: its gradient equals
        P(top | x_i = 1) - P(top | x_i = 0), by enumeration."""
        tree, top, events = _small_mef(seed)
        p = jnp.asarray(mean_basic_probabilities(tree))
        modular = build_modular_bdd(tree)
        grad = np.asarray(jax.grad(
            lambda q: modular_probability(modular, q))(p))
        for event in events[:4]:
            if event.id not in tree.basic_index:
                continue
            slot = tree.basic_index[event.id]
            saved = event.expression
            from canopy_tpu.mef.expr import ConstantExpression
            event.expression = ConstantExpression(1.0)
            on = brute_force_probability(top, events)
            event.expression = ConstantExpression(0.0)
            off = brute_force_probability(top, events)
            event.expression = saved
            assert grad[slot] == pytest.approx(on - off, abs=1e-12)

    @pytest.mark.parametrize("seed", SMALL_SEEDS)
    def test_importance_measures_exact(self, seed):
        tree, top, events = _small_mef(seed)
        p = jnp.asarray(mean_basic_probabilities(tree))
        modular = build_modular_bdd(tree)
        imp = importance_measures(
            tree, p, top_fn=lambda q: modular_probability(modular, q))
        want = brute_force_probability(top, events)
        assert imp.top_probability == pytest.approx(want, abs=1e-13)
        assert np.all(np.isfinite(imp.mif))
        # CIF = p * MIF / P by definition.
        np.testing.assert_allclose(imp.cif, np.asarray(p) * imp.mif / want,
                                   rtol=1e-12, atol=1e-15)


class TestFusedChain:
    @pytest.mark.parametrize("name", ["mixed-house", "mef-shared",
                                      "mef-counts", "hierarchical"])
    def test_segments_cover_levels(self, name):
        modular = build_modular_bdd(tree_of(name))
        fused = modular.fused()
        assert modular.fused() is fused              # Built once.
        n_levels = sum(rows.shape[0] for rows, _out in fused.segments)
        assert n_levels == len(fused.levels)
        written = []
        for rows, out in fused.segments:
            width = out.shape[1]
            assert width & (width - 1) == 0          # Power of two.
            assert rows.shape[1] == 3 * width
            pad = out == fused.n_rows
            stacked = rows.reshape(rows.shape[0], 3, width)
            assert (stacked.transpose(1, 0, 2)[:, pad] == fused.n_rows).all()
            written.extend(out[~pad].tolist())
        assert sorted(written) == list(range(2 + fused.n_basic,
                                             fused.n_rows))

    @pytest.mark.parametrize("name", ["mef-shared", "hierarchical"])
    def test_levels_read_only_earlier_rows(self, name):
        fused = build_modular_bdd(tree_of(name)).fused()
        for rows, out_start in fused.levels:
            assert rows.max() < out_start
        widths = [len(r) // 3 for r, _ in fused.levels]
        assert sum(widths) == build_modular_bdd(
            tree_of(name)).total_nodes

    def test_constant_top(self):
        from canopy_tpu.mef.event import (Arg, BasicEvent, Connective,
                                          Formula, Gate)
        from canopy_tpu.mef.expr import ConstantExpression
        a = BasicEvent("ca")
        a.expression = ConstantExpression(0.5)
        g1 = Gate("cg1")
        g1.formula = Formula(Connective.NULL, [Arg(a)])
        top = Gate("ctop")                       # a -> a: always true.
        top.formula = Formula(Connective.IMPLY, [Arg(g1), Arg(a)])
        tree = compile_gates([top])
        tree.top_index = tree.gate_index["ctop"]
        out = modular_probability(build_modular_bdd(tree),
                                  jnp.full((5, 1), 0.3))
        np.testing.assert_array_equal(np.asarray(out), np.ones(5))


class TestChunkedMonteCarlo:
    @pytest.mark.parametrize("chunk", [1024, 4096])
    def test_converges_to_exact(self, chunk, monkeypatch):
        tree, top, events = _small_mef(17)
        monkeypatch.setattr(bitpack, "_CHUNK_ELEMENTS", chunk * tree.n_basic)
        p = jnp.asarray(mean_basic_probabilities(tree))
        exact = brute_force_probability(top, events)
        n = 1 << 16
        est = float(packed_top_probability(tree, jax.random.PRNGKey(0), p,
                                           n))
        assert abs(est - exact) < 5 * np.sqrt(exact * (1 - exact) / n)

    def test_rounds_up_to_whole_chunks(self, monkeypatch):
        """With every event certain the top always fires: the estimate is
        exactly 1 only if hits and denominator both count the 1,024
        trials that 1,000 round up to, though the three chunks of 384
        draw 1,152 (the last chunk's tail is not counted)."""
        tree = tree_of("uniform-shallow")
        monkeypatch.setattr(bitpack, "_CHUNK_ELEMENTS", 384 * tree.n_basic)
        est = float(packed_top_probability(
            tree, jax.random.PRNGKey(1), jnp.ones(tree.n_basic), 1000))
        assert est == 1.0

    def test_unchunked_path_unchanged(self):
        """A run that fits one chunk is one draw with ``fold_in(key, 0)``
        through the packed engine."""
        tree = tree_of("mixed-house")
        p = jnp.asarray(mean_basic_probabilities(tree))
        key = jax.random.PRNGKey(2)
        house = jnp.asarray(tree.house_state_vector())
        packed = bitpack.sample_states_packed(jax.random.fold_in(key, 0), p,
                                              2048)
        top = bitpack.propagate_packed(tree, packed, house)[tree.top_index]
        want = bitpack.popcount_mean(top, 2048)
        assert float(packed_top_probability(tree, key, p, 2048)) \
            == float(want)


def _same_level_tree(forward: bool) -> CompiledTree:
    """Two basics, two level-0 gates; gate 3 reads gate 2 (same level)
    or, with ``forward``, gate 2 reads gate 3 (a later slot)."""
    args = np.array([[0, 1], [2, 1]] if not forward else [[0, 3], [0, 1]],
                    dtype=np.int32)
    block = ProdBlock(np.array([2, 3], np.int32), args,
                      np.zeros((2, 2), bool), np.ones((2, 2), bool),
                      np.zeros(2, bool))
    return CompiledTree(n_basic=2, n_house=0, n_gates=2, basic_index={},
                        house_index={}, gate_index={},
                        levels=[LevelBlock([block], [], [])],
                        basic_events=[], house_events=[], gates=[],
                        top_index=2 if forward else 3)


class TestTopConeLevelling:
    @pytest.mark.parametrize("forward", [False, True])
    def test_same_level_argument_raises(self, forward):
        with pytest.raises(LogicError, match="strictly levelled"):
            prune_to_top_cone(_same_level_tree(forward))

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_compiled_trees_pass_and_stay_exact(self, name):
        tree = tree_of(name)
        cone = prune_to_top_cone(tree)
        p = batch_of(tree, 8, seed=14)
        np.testing.assert_allclose(
            numpy_propagate(cone, p)[:, cone.top_index],
            numpy_propagate(tree, p)[:, tree.top_index], rtol=1e-14)


class TestEmitGateOps:
    """``_emit_gate_ops`` lives with the compiler (``compiler/graph.py``);
    the BDD builders read array-backed trees through it."""

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_one_row_per_gate(self, name):
        tree = tree_of(name)
        rows = _emit_gate_ops(tree)
        assert len(rows) == tree.n_gates
        assert sorted(r[1] for r in rows) == list(range(
            tree.n_basic + tree.n_house, tree.n_nodes))
        assert sum(len(r[2]) for r in rows) == tree.nnz

    def test_old_module_is_gone(self):
        with pytest.raises(ImportError):
            __import__("canopy_tpu.compiler.schedule")

    def test_array_backed_bdd_matches_object_bdd(self):
        """A tree with no gate objects builds its BDD from the rows."""
        tree = tree_of("mef-counts")
        stripped = CompiledTree(
            n_basic=tree.n_basic, n_house=tree.n_house,
            n_gates=tree.n_gates, basic_index=tree.basic_index,
            house_index=tree.house_index, gate_index=tree.gate_index,
            levels=tree.levels, basic_events=tree.basic_events,
            house_events=tree.house_events, gates=[],
            top_index=tree.top_index)
        p = jnp.asarray(batch_of(tree, 8, seed=15))
        np.testing.assert_allclose(
            np.asarray(bdd_probability(build_bdd(stripped), p)),
            np.asarray(bdd_probability(build_bdd(tree), p)), rtol=1e-13)
        np.testing.assert_allclose(
            np.asarray(modular_probability(build_modular_bdd(stripped), p)),
            np.asarray(modular_probability(build_modular_bdd(tree), p)),
            rtol=1e-13)


def test_brute_force_helper_agrees_with_numpy_reference():
    """The two references agree where direct propagation is exact (no
    shared events), so neither hides a bug in the other."""
    from canopy_tpu.mef.event import Arg, BasicEvent, Connective, Formula, Gate
    from canopy_tpu.mef.expr import ConstantExpression
    events = []
    for i, p in enumerate([0.1, 0.2, 0.3, 0.4, 0.5]):
        e = BasicEvent(f"x{i}")
        e.expression = ConstantExpression(p)
        events.append(e)
    g = Gate("v")
    g.formula = Formula(Connective.ATLEAST, [Arg(e) for e in events[:3]],
                        min_number=2)
    top = Gate("t")
    top.formula = Formula(Connective.XOR, [Arg(g), Arg(events[3], True)])
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["t"]
    got = numpy_propagate(tree, mean_basic_probabilities(tree))[0,
                                                               tree.top_index]
    assert got == pytest.approx(brute_force_probability(top, events[:4]),
                                abs=1e-15)


class TestMonolithicBddAsChain:
    """A monolithic BDD runs as a one-module :class:`FusedChain`."""

    @pytest.mark.parametrize("name", ["mixed-house", "mef-shared",
                                      "mef-counts", "hierarchical"])
    def test_levels_match_schedule(self, name):
        bdd = build_bdd(tree_of(name))
        fused = bdd.fused()
        assert bdd.fused() is fused                  # Built once.
        assert [len(r) // 3 for r, _ in fused.levels] \
            == [len(level[0]) for level in bdd.levels]
        assert fused.n_rows == 2 + bdd.n_basic + bdd.n_nodes
        for rows, out_start in fused.levels:
            assert rows.max() < out_start

    @pytest.mark.parametrize("state", [0.0, 1.0])
    def test_constant_bdd(self, state):
        """A house event that decides the top leaves a terminal root:
        AND(h, a) with h false, OR(h, a) with h true."""
        from canopy_tpu.mef.event import (Arg, BasicEvent, Connective,
                                          Formula, Gate, HouseEvent)
        from canopy_tpu.mef.expr import ConstantExpression
        a = BasicEvent("ka")
        a.expression = ConstantExpression(0.5)
        h = HouseEvent("kh", state=bool(state))
        top = Gate("ktop")
        top.formula = Formula(Connective.OR if state else Connective.AND,
                              [Arg(h), Arg(a)])
        tree = compile_gates([top])
        tree.top_index = tree.gate_index["ktop"]
        bdd = build_bdd(tree)
        assert bdd.n_nodes == 0 and bdd.fused().segments == []
        out = bdd_probability(bdd, jnp.full((3, 2, 1), 0.3))
        np.testing.assert_array_equal(np.asarray(out),
                                      np.full((3, 2), state))
