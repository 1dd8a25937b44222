"""The analysis driver: Settings x Model -> Report.

The orchestration layer the reference specified but never built (its CLI
and engine are absent; ``Settings`` + CI are the contract — SURVEY.md §1).
One :class:`RiskAnalysis` run covers, per fault-tree top event:

* **probability** — per the configured approximation: exact-style direct
  propagation (``none``), rare-event/MCUB over minimal products, or
  Monte-Carlo state simulation;
* **products** — MOCUS-style minimal cut sets (unless ``skip_products``),
  with non-declarative substitutions applied (delete-terms /
  recovery-rule / exchange-event semantics);
* **importance** — autodiff-based measures (one backward pass);
* **uncertainty** — batched epistemic sampling through the expression
  tape (SpMM configuration);
* **SIL** — a time sweep of the same compiled program over the mission
  time (the tape treats mission time as a traced input) with PFD/PFH
  averages and IEC 61508 bucket assignment;

and per initiating event: the event-tree walk with per-sequence
quantification. Alignment phases re-run probability analysis per phase
with phase-local house states and scaled mission time.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.bdd import BddBlowupError, build_bdd
from ..compiler.cutsets import CutSetGenerator, Product
from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import CompiledTree, compile_fault_tree, compile_gates
from ..errors import LogicError
from ..mef.event import BasicEvent, Gate
from ..mef.model import Model
from ..settings import Algorithm, Approximation, Settings
from .bdd_eval import bdd_probability, make_bdd_evaluator
from .cutset_quantify import (build_cutset_matrix, mcub,
                              product_probabilities, rare_event)
from .event_tree_walk import walk_event_tree
from .importance import importance_measures, occurrence_counts
from .propagate import propagate_probability, top_event_probability
from .sampler import monte_carlo_ci, sample_top_probability
from .uncertainty import uncertainty_analysis

__all__ = ["RiskAnalysis", "Report", "FaultTreeResult", "SequenceResult"]

#: IEC 61508 SIL bands for average probability of failure on demand.
_SIL_PFD_BANDS = [(1e-5, 1e-4, 4), (1e-4, 1e-3, 3), (1e-3, 1e-2, 2),
                  (1e-2, 1e-1, 1)]


@dataclasses.dataclass
class FaultTreeResult:
    fault_tree: str
    top_event: str
    method: str
    probability: Optional[float] = None
    mc_std_error: Optional[float] = None
    products: Optional[list[tuple]] = None      # [(order, prob, [literals])]
    n_products: Optional[int] = None
    products_truncated: bool = False
    importance: Optional[list[dict]] = None
    uncertainty: Optional[dict] = None
    sil: Optional[dict] = None
    phase: Optional[str] = None
    alignment: Optional[str] = None
    time_curve: Optional[list[tuple[float, float]]] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class SequenceResult:
    initiating_event: str
    event_tree: str
    sequence: str
    states: dict[str, str]
    probability: float
    linked_trees: list[str]
    uncertainty: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    model: str
    settings: dict
    fault_trees: list[FaultTreeResult]
    sequences: list[SequenceResult]
    timings: dict[str, float]

    def to_dict(self) -> dict:
        return {"model": self.model, "settings": self.settings,
                "fault_trees": [r.to_dict() for r in self.fault_trees],
                "sequences": [s.to_dict() for s in self.sequences],
                "timings": self.timings}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), default=_json_default, **kw)


def _json_default(obj: Any):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Cannot serialize {type(obj)}")


class RiskAnalysis:
    """Runs every analysis requested by the settings on a model."""

    def __init__(self, model: Model, settings: Settings):
        self.model = model
        self.settings = settings
        self._timings: dict[str, float] = {}

    # -- public ------------------------------------------------------------

    def run(self) -> Report:
        t0 = time.perf_counter()
        results: list[FaultTreeResult] = []
        sequences: list[SequenceResult] = []

        if self.settings.preprocessor:
            # Stop after model setup (settings.h:310): report structure
            # only, no quantification.
            for fault_tree in self.model.fault_trees:
                if not fault_tree.top_events:
                    fault_tree.collect_top_events()
                for top in fault_tree.top_events:
                    results.append(FaultTreeResult(
                        fault_tree=fault_tree.name, top_event=top.id,
                        method="preprocessor-only"))
            self._timings["total"] = time.perf_counter() - t0
            return Report(model=self.model.name,
                          settings=self.settings.to_dict(),
                          fault_trees=results, sequences=[],
                          timings=dict(self._timings))

        for fault_tree in self.model.fault_trees:
            if not fault_tree.top_events:
                fault_tree.collect_top_events()
            for top in fault_tree.top_events:
                results.extend(self._analyze_top(fault_tree.name, top))

        for initiating in self.model.initiating_events:
            if initiating.event_tree is not None:
                sequences.extend(self._analyze_event_tree(initiating))

        self._timings["total"] = time.perf_counter() - t0
        return Report(model=self.model.name,
                      settings=self.settings.to_dict(),
                      fault_trees=results, sequences=sequences,
                      timings=dict(self._timings))

    # -- fault trees -------------------------------------------------------

    def _analyze_top(self, tree_name: str, top: Gate,
                     house_overrides: dict[str, bool] | None = None,
                     mission_time: float | None = None,
                     tag: tuple[str, str] | None = None
                     ) -> list[FaultTreeResult]:
        settings = self.settings
        t0 = time.perf_counter()
        tree = compile_fault_tree(
            _FaultTreeView(tree_name, [top]), top,
            use_ccf=settings.ccf_analysis())
        self._timings[f"compile:{top.id}"] = time.perf_counter() - t0

        mission = (settings.mission_time() if mission_time is None
                   else mission_time)
        self.model.mission_time.set_value(mission)
        tape = ExpressionTape.build(
            [e.expression for e in tree.basic_events])
        mean_p = jnp.clip(tape.evaluate_mean(mission), 0.0, 1.0)

        house = tree.house_state_vector()
        if house_overrides:
            for event_id, state in house_overrides.items():
                slot = tree.house_index.get(event_id)
                if slot is not None:
                    house[slot - tree.n_basic] = 1.0 if state else 0.0
        house = jnp.asarray(house)

        # Exact (BDD) evaluator: the default algorithm. House states fold
        # into the BDD structure, so it is built after overrides apply.
        # Modular decomposition (Dutuit-Rauzy) keeps per-module BDDs
        # small; a tree with no modules degenerates to one monolithic BDD.
        top_fn = None
        method = self._method_name()
        if settings.algorithm() == Algorithm.BDD and \
                settings.approximation() == Approximation.NONE:
            try:
                t0 = time.perf_counter()
                from ..compiler.modules import (build_modular_bdd,
                                                modular_probability)
                modular = build_modular_bdd(tree,
                                            house_states=np.asarray(house))
                top_fn = jax.jit(functools.partial(modular_probability,
                                                   modular))
                self._timings[f"bdd:{top.id}"] = time.perf_counter() - t0
            except BddBlowupError:
                method = "bdd-fallback/direct-propagation"

        result = FaultTreeResult(
            fault_tree=tree_name, top_event=top.id, method=method)
        if tag:
            result.alignment, result.phase = tag

        # Products (qualitative analysis).
        products: list[Product] | None = None
        if not settings.skip_products() and settings.algorithm() in (
                Algorithm.MOCUS, Algorithm.ZBDD, Algorithm.BDD,
                Algorithm.DIRECT):
            t0 = time.perf_counter()
            generator = CutSetGenerator(
                tree, limit_order=settings.limit_order(),
                cut_off=settings.cut_off()
                if settings.approximation() != Approximation.NONE else 0.0,
                probabilities=np.asarray(mean_p))
            products = None
            bdd_truncated = None
            if top_fn is not None and not settings.prime_implicants():
                # Exact minimal cut sets via the ZBDD minimal-solutions
                # transform over a monolithic BDD (module pseudo-events
                # would leak into products otherwise).
                try:
                    from ..compiler.zbdd import bdd_minimal_cut_sets
                    bdd = build_bdd(tree, house_states=np.asarray(house))
                    products, bdd_truncated = bdd_minimal_cut_sets(
                        bdd, limit_order=settings.limit_order(),
                        with_truncation=True)
                except BddBlowupError:
                    products = None
            elif top_fn is not None:
                # True prime implicants via the Coudert-Madre consensus
                # recursion on the ROBDD (settings.h:77-90 — the
                # BDD-algorithm PI mode; includes consensus products the
                # MOCUS fallback cannot produce).
                try:
                    from ..compiler.prime_implicants import \
                        bdd_prime_implicants
                    bdd = build_bdd(tree, house_states=np.asarray(house))
                    products, bdd_truncated = bdd_prime_implicants(
                        bdd, limit_order=settings.limit_order(),
                        with_truncation=True)
                except (BddBlowupError, LogicError):
                    # MOCUS stand-in misses consensus implicants on
                    # non-coherent trees: record the demotion (the
                    # exactness-ladder rule — never demote silently).
                    products = None
                    result.method += "/pi-fallback-mocus-approx"
            if products is None:
                products = generator.generate(top)
            if not settings.prime_implicants():
                # Minimal-cut-set mode: complemented literals are dropped
                # (conservative coherent approximation — SCRAM's MOCUS
                # behavior); prime-implicant mode keeps full literal
                # products (BDD-algorithm-only, per settings.h:77-90).
                products = CutSetGenerator._minimize(
                    frozenset(lit for lit in p if not lit[1])
                    for p in products)
            products = self._apply_substitutions(tree, products)
            result.products_truncated = (bdd_truncated
                                         if bdd_truncated is not None
                                         else generator.truncated)
            result.n_products = len(products)
            self._timings[f"products:{top.id}"] = time.perf_counter() - t0

        if settings.probability_analysis():
            t0 = time.perf_counter()
            approx = settings.approximation()
            if approx == Approximation.NONE:
                if top_fn is not None:
                    result.probability = float(top_fn(mean_p))
                else:
                    result.probability = float(
                        top_event_probability(tree, mean_p, house))
            elif approx in (Approximation.RARE_EVENT, Approximation.MCUB):
                matrix = build_cutset_matrix(products or [], tree.n_basic)
                q = product_probabilities(matrix, mean_p)
                value = rare_event(q) if approx == Approximation.RARE_EVENT \
                    else mcub(q)
                result.probability = float(value)
            else:  # Monte Carlo state simulation (bit-packed engine).
                from .sampler import monte_carlo_ci
                from ..ops.bitpack import packed_top_probability

                n = settings.num_trials() * settings.sample_size()
                n = -(-n // 32) * 32  # Round up to whole uint32 words.
                key = jax.random.PRNGKey(settings.seed())
                estimate = packed_top_probability(tree, key, mean_p, n,
                                                  house)
                result.probability = float(estimate)
                result.mc_std_error = float(monte_carlo_ci(estimate, n))
            self._timings[f"probability:{top.id}"] = time.perf_counter() - t0

        if products is not None:
            probs = np.asarray(product_probabilities(
                build_cutset_matrix(products, tree.n_basic), mean_p)) \
                if products else np.zeros(0)
            listed = sorted(zip(products, probs),
                            key=lambda pair: -pair[1])
            result.products = [
                (len(p), float(q), sorted(
                    self._literal_name(tree, slot, neg) for slot, neg in p))
                for p, q in listed[:1000]]

        if settings.importance_analysis():
            t0 = time.perf_counter()
            imp = importance_measures(tree, mean_p, house, top_fn=top_fn)
            if products is not None:
                imp.occurrences = occurrence_counts(products, tree.n_basic)
            result.importance = imp.as_table(tree)
            self._timings[f"importance:{top.id}"] = time.perf_counter() - t0

        if settings.uncertainty_analysis() and tape.n_deviates:
            t0 = time.perf_counter()
            # Uncertainty propagates through the same quantification the
            # point estimate used: exact BDD when available, otherwise
            # the configured cut-set approximation per trial (the batched
            # SpMM configuration), otherwise direct propagation.
            unc_fn = top_fn
            if unc_fn is None and products is not None and \
                    settings.approximation() in (Approximation.RARE_EVENT,
                                                 Approximation.MCUB):
                matrix_u = build_cutset_matrix(products, tree.n_basic)
                reducer = (rare_event
                           if settings.approximation() ==
                           Approximation.RARE_EVENT else mcub)
                unc_fn = lambda p: reducer(  # noqa: E731
                    product_probabilities(matrix_u, p))
            unc = uncertainty_analysis(
                tree, tape, jax.random.PRNGKey(settings.seed()),
                settings.num_trials(), mission,
                num_quantiles=settings.num_quantiles(),
                num_bins=settings.num_bins(), house_states=house,
                batch_size=(settings.batch_size()
                            if settings.batch_size() > 1 else None),
                top_fn=unc_fn)
            ci = unc.confidence_interval(0.95)
            result.uncertainty = {
                "mean": unc.mean, "std": unc.std,
                "error_factor": unc.error_factor,
                "ci95": list(ci), "n_trials": unc.n_trials,
                "quantiles": unc.quantiles.tolist(),
                "histogram_edges": unc.histogram_edges.tolist(),
                "histogram_density": unc.histogram_density.tolist()}
            self._timings[f"uncertainty:{top.id}"] = time.perf_counter() - t0

        if settings.safety_integrity_levels():
            result.sil, result.time_curve = self._sil_analysis(
                tree, tape, house, mission, top_fn=top_fn)
        elif settings.time_step() > 0 and settings.probability_analysis():
            # Time-stepped probability curve without the SIL metrics.
            _, result.time_curve = self._sil_analysis(
                tree, tape, house, mission, top_fn=top_fn)

        out = [result]

        # Alignment phases (only at the root call): one compile + one
        # batched evaluation for all phases in the default BDD-exact
        # configuration (phase mission times batch through the traced
        # expression tape, phase house vectors group by distinct config
        # like the event-tree house_batch); analyses that produce
        # per-phase derived artifacts (importance, uncertainty, SIL,
        # time curves, non-default approximations) keep the faithful
        # per-phase re-analysis.
        if house_overrides is None and tag is None and \
                self.model.alignments:
            batched_ok = (
                settings.algorithm() == Algorithm.BDD
                and settings.approximation() == Approximation.NONE
                and not settings.prime_implicants()
                and not settings.importance_analysis()
                and not settings.uncertainty_analysis()
                and not settings.safety_integrity_levels()
                and settings.time_step() <= 0)
            if batched_ok:
                out.extend(self._analyze_phases_batched(
                    tree_name, top, tree, tape, mission))
            else:
                for alignment in self.model.alignments:
                    for phase in alignment.phases:
                        overrides = {inst.name: inst.state
                                     for inst in phase.instructions}
                        out.extend(self._analyze_top(
                            tree_name, top, house_overrides=overrides,
                            mission_time=mission * phase.time_fraction,
                            tag=(alignment.name, phase.name)))
        return out

    def _analyze_phases_batched(self, tree_name: str, top: Gate, tree,
                                tape, mission: float
                                ) -> list[FaultTreeResult]:
        """All alignment phases of ``top`` in one batched pass.

        Reuses the root analysis' compiled tree and expression tape (no
        per-phase recompile); phase mean probabilities come from ONE
        batched tape evaluation over the phase mission times; phases
        group by distinct house configuration — each group shares one
        modular BDD and one products run (mission-independent at
        approximation NONE) and quantifies all its phases in one
        batched evaluation.  Ref: ``alignment.h:17-37``,
        ``phase.h:7-37``; the event-tree house batching is
        ``_analyze_event_tree``.
        """
        settings = self.settings
        t0 = time.perf_counter()
        house_rows, times, tags = [], [], []
        for alignment in self.model.alignments:
            for phase in alignment.phases:
                house = tree.house_state_vector()
                for inst in phase.instructions:
                    slot = tree.house_index.get(inst.name)
                    if slot is not None:
                        house[slot - tree.n_basic] = \
                            1.0 if inst.state else 0.0
                house_rows.append(house)
                times.append(mission * phase.time_fraction)
                tags.append((alignment.name, phase.name))
        p_batch = jnp.clip(
            tape.evaluate_mean(jnp.asarray(np.asarray(times))), 0.0, 1.0)
        results: list[FaultTreeResult | None] = [None] * len(tags)
        by_house: dict[bytes, list[int]] = {}
        for i, h in enumerate(house_rows):
            by_house.setdefault(h.tobytes(), []).append(i)
        for ks in by_house.values():
            house = house_rows[ks[0]]
            method = self._method_name()
            top_fn = None
            try:
                from ..compiler.modules import (build_modular_bdd,
                                                modular_probability)
                modular = build_modular_bdd(tree,
                                            house_states=np.asarray(house))
                top_fn = lambda p, m=modular: modular_probability(m, p)  # noqa: E731
            except BddBlowupError:
                method = "bdd-fallback/direct-propagation"
            products = None
            truncated = None
            if not settings.skip_products():
                generator = CutSetGenerator(
                    tree, limit_order=settings.limit_order(), cut_off=0.0,
                    probabilities=np.asarray(p_batch[ks[0]]))
                if top_fn is not None:
                    try:
                        from ..compiler.zbdd import bdd_minimal_cut_sets
                        bdd = build_bdd(tree,
                                        house_states=np.asarray(house))
                        products, truncated = bdd_minimal_cut_sets(
                            bdd, limit_order=settings.limit_order(),
                            with_truncation=True)
                    except BddBlowupError:
                        products = None
                if products is None:
                    products = generator.generate(top)
                    truncated = generator.truncated
                products = CutSetGenerator._minimize(
                    frozenset(lit for lit in p if not lit[1])
                    for p in products)
                products = self._apply_substitutions(tree, products)
            # ONE batched quantification across this group's phases.
            group_p = p_batch[jnp.asarray(np.asarray(ks))]
            probs = None
            if settings.probability_analysis():
                if top_fn is not None:
                    probs = np.asarray(top_fn(group_p))
                else:
                    probs = np.asarray(top_event_probability(
                        tree, group_p, jnp.asarray(house)))
            prod_probs = None
            if products:
                prod_probs = np.asarray(product_probabilities(
                    build_cutset_matrix(products, tree.n_basic), group_p))
            for j, k in enumerate(ks):
                result = FaultTreeResult(
                    fault_tree=tree_name, top_event=top.id, method=method)
                result.alignment, result.phase = tags[k]
                if probs is not None:
                    result.probability = float(probs[j])
                if products is not None:
                    result.n_products = len(products)
                    result.products_truncated = truncated
                    qs = prod_probs[j] if prod_probs is not None \
                        else np.zeros(0)
                    listed = sorted(zip(products, qs),
                                    key=lambda pair: -pair[1])
                    result.products = [
                        (len(p), float(q), sorted(
                            self._literal_name(tree, slot, neg)
                            for slot, neg in p))
                        for p, q in listed[:1000]]
                results[k] = result
        self._timings[f"phases:{top.id}"] = time.perf_counter() - t0
        return [r for r in results if r is not None]

    def _method_name(self) -> str:
        algo = self.settings.algorithm().name.lower()
        approx = self.settings.approximation().name.lower()
        return f"{algo}/{approx}" if approx != "none" else \
            f"{algo}/direct-propagation"

    def _literal_name(self, tree: CompiledTree, slot: int, neg: bool) -> str:
        # Precomputed slot -> name array, cached ON the tree instance
        # (an id()-keyed dict would alias a freed tree's address to a
        # new one and return wrong names): the dict scan was O(n_basic)
        # per literal — quadratic over large product lists.
        names = getattr(tree, "_slot_name_cache", None)
        if names is None:
            names = [None] * tree.n_basic
            for event_id, s in tree.basic_index.items():
                names[s] = event_id
            tree._slot_name_cache = names
        event_id = names[slot] if slot < len(names) else None
        if event_id is None:
            return f"slot{slot}"
        return f"not {event_id}" if neg else event_id

    # -- SIL ---------------------------------------------------------------

    def _sil_analysis(self, tree: CompiledTree, tape: ExpressionTape,
                      house, mission: float, top_fn=None):
        step = self.settings.time_step()
        times = np.arange(step, mission + step / 2, step)
        if len(times) == 0:
            times = np.array([mission])
        # One batched evaluation: mission time is a traced input of the
        # tape, so the whole sweep is a single vectorized pass.
        p_t = jnp.clip(tape.evaluate_mean(jnp.asarray(times)), 0.0, 1.0)
        if top_fn is not None:
            curve_arr = np.asarray(top_fn(p_t), dtype=np.float64)
        else:
            curve_arr = np.asarray(
                top_event_probability(tree, p_t, house), dtype=np.float64)
        pfd_avg = float(curve_arr.mean())
        # Average failure frequency (PFH): mean d/dt of the curve.
        pfh_avg = float(np.gradient(curve_arr, times).mean()) \
            if len(times) > 1 else pfd_avg / float(times[0])
        sil_level = 0
        for lo, hi, level in _SIL_PFD_BANDS:
            if lo <= pfd_avg < hi:
                sil_level = level
                break
        # Fraction of time in each band (SCRAM-style SIL fractions).
        fractions = {}
        for lo, hi, level in _SIL_PFD_BANDS:
            fractions[f"SIL{level}"] = float(
                np.mean((curve_arr >= lo) & (curve_arr < hi)))
        sil = {"pfd_avg": pfd_avg, "pfh_avg": pfh_avg,
               "sil_level": sil_level, "pfd_fractions": fractions}
        time_curve = list(zip(times.tolist(), curve_arr.tolist()))
        return sil, time_curve

    # -- substitutions -----------------------------------------------------

    def _apply_substitutions(self, tree: CompiledTree,
                             products: list[Product]) -> list[Product]:
        """Apply substitution semantics at the product level."""
        substitutions = list(self.model.substitutions)
        if not substitutions:
            return products

        def slot_of(event: BasicEvent) -> int | None:
            return tree.basic_index.get(event.id)

        out = products
        for substitution in substitutions:
            hypothesis_slots = []
            skip = False
            for arg in substitution.hypothesis.args:
                slot = slot_of(arg.event)
                if slot is None:
                    skip = True
                    break
                hypothesis_slots.append((slot, arg.complement))
            if skip:
                continue
            hyp = set(hypothesis_slots)
            source_slots = {slot_of(e) for e in substitution.source}
            source_slots.discard(None)
            target = substitution.target

            new_products: list[Product] = []
            for product in out:
                literals = set(product)
                if not hyp <= literals:
                    new_products.append(product)
                    continue
                # Hypothesis satisfied by this product.
                if target is False:
                    continue  # delete-terms: drop the product.
                if target is True or not source_slots:
                    new_products.append(product)
                    continue
                replaced = {lit for lit in literals
                            if lit[0] not in source_slots}
                if isinstance(target, BasicEvent):
                    t_slot = slot_of(target)
                    if t_slot is not None:
                        replaced.add((t_slot, False))
                new_products.append(frozenset(replaced))
            out = new_products
        # Re-minimize after rewriting.
        return CutSetGenerator._minimize(out)

    # -- event trees -------------------------------------------------------

    def _analyze_event_tree(self, initiating) -> list[SequenceResult]:
        """All sequences quantified over ONE shared compiled structure.

        Sequence conditions overlap heavily (each path conjoins pieces of
        the same fault trees), so the per-sequence gates compile together
        as a multi-root DAG — shared subtrees appear once, the BDD forest
        memoizes across roots, and one batched evaluation covers every
        sequence (the gate-composition form of the chained-SpGEMM
        linking in BASELINE.json config 4).
        """
        t0 = time.perf_counter()
        outcomes = walk_event_tree(self.model, initiating)
        mission = self.settings.mission_time()

        gates = [outcome.conjoined_gate(f"__seq{i}__")
                 for i, outcome in enumerate(outcomes)]
        roots = [g for g in gates if g is not None]
        values: dict[int, float] | None = {}
        if roots:
            tree = compile_gates(roots, use_ccf=self.settings.ccf_analysis())
            tape = ExpressionTape.build(
                [e.expression for e in tree.basic_events])
            mean_p = jnp.clip(tape.evaluate_mean(mission), 0.0, 1.0)
            # House states may differ per outcome (path-local flips), so
            # evaluation batches over one house vector per sequence.
            house_rows = []
            for outcome, gate in zip(outcomes, gates):
                if gate is None:
                    continue
                house = tree.house_state_vector()
                for event_id, state in outcome.house_states.items():
                    slot = tree.house_index.get(event_id)
                    if slot is not None:
                        house[slot - tree.n_basic] = 1.0 if state else 0.0
                house_rows.append(house)
            house_batch = jnp.asarray(np.stack(house_rows)) if house_rows \
                else jnp.zeros((0, tree.n_house))
            uniform_house = bool(
                house_rows and
                all((h == house_rows[0]).all() for h in house_rows))
            use_bdd = self.settings.algorithm() == Algorithm.BDD
            values = None
            root_bdds = None
            if use_bdd:
                # ONE forest pass per distinct house configuration
                # (usually one): the ITE memo tables are shared across
                # all sequence roots (compiler/bdd.build_bdd_multi), so
                # 50 sequences cost one forest + 50 cheap schedules
                # instead of 50 forest rebuilds.
                from ..compiler.bdd import build_bdd_multi
                try:
                    root_slots = [tree.gate_index[g.id] for g in gates
                                  if g is not None]
                    n_roots = len(root_slots)
                    root_bdds = [None] * n_roots
                    values = {}
                    by_house: dict[bytes, list[int]] = {}
                    for k in range(n_roots):
                        by_house.setdefault(
                            house_rows[k].tobytes(), []).append(k)
                    for ks in by_house.values():
                        bdds = build_bdd_multi(
                            tree, [root_slots[k] for k in ks],
                            house_states=house_rows[ks[0]])
                        for k, bdd in zip(ks, bdds):
                            root_bdds[k] = bdd
                            values[k] = float(bdd_probability(bdd, mean_p))
                except BddBlowupError:
                    values = None
                    root_bdds = None
            if values is None:
                # One batched propagation: row k uses house vector k.
                all_vals = propagate_probability(tree, mean_p[None, :],
                                                 house_batch)
                root_slots = [tree.gate_index[g.id] for g in gates
                              if g is not None]
                values = {k: float(all_vals[k, slot])
                          for k, slot in enumerate(root_slots)}

        results = []
        cursor = 0
        seq_unc = None
        if roots and self.settings.uncertainty_analysis():
            seq_unc = self._sequence_uncertainty(
                initiating, outcomes, gates, tree, house_rows,
                uniform_house, mission, root_bdds)

        for k, (outcome, gate) in enumerate(zip(outcomes, gates)):
            probability = 1.0
            if getattr(initiating, "expression", None) is not None:
                probability *= initiating.expression.value()
            for expression in outcome.expressions:
                probability *= expression.value()
            if gate is not None:
                probability *= values[cursor]
                cursor += 1
            results.append(SequenceResult(
                initiating_event=initiating.name,
                event_tree=initiating.event_tree.name,
                sequence=outcome.sequence.name,
                states=outcome.states,
                probability=probability,
                linked_trees=outcome.linked_trees,
                uncertainty=seq_unc.get(k) if seq_unc else None))
        self._timings[f"event-tree:{initiating.name}"] = \
            time.perf_counter() - t0
        return results

    def _sequence_uncertainty(self, initiating, outcomes, gates, tree,
                              house_rows, uniform_house, mission,
                              root_bdds=None) -> dict[int, dict] | None:
        """Per-sequence epistemic uncertainty over the shared structure.

        One expression tape covers the fault-tree basics, the initiating
        frequency, and every collected expression, so shared parameters
        sample once per trial (the reference's memoize-per-trial
        semantics, §3.3). Sequence condition tops evaluate exactly over
        the BDDs the point estimates already built (``root_bdds``);
        otherwise by direct propagation, and each
        sequence's dict carries a ``method`` field so demotion from the
        exactness ladder is never silent.
        """
        settings = self.settings
        init_expr = getattr(initiating, "expression", None)
        extras = ([init_expr] if init_expr is not None else []) + \
            [e for outcome in outcomes for e in outcome.expressions]
        tape_u = ExpressionTape.build(
            [e.expression for e in tree.basic_events] + extras)
        if not tape_u.n_deviates:
            return None
        n_trials = settings.num_trials()
        import zlib
        key = jax.random.fold_in(  # crc32: stable across processes,
            jax.random.PRNGKey(settings.seed()),   # unlike str hash().
            int(zlib.crc32(initiating.name.encode()) & 0x7FFFFFFF))
        samples = tape_u.sample(key, n_trials, mission)
        basic_s = jnp.clip(samples[:, :tree.n_basic], 0.0, 1.0)
        col = tree.n_basic
        init_s = None
        if init_expr is not None:
            init_s = samples[:, col]
            col += 1

        live_gates = [g for g in gates if g is not None]
        root_slots = [tree.gate_index[g.id] for g in live_gates]
        top_trials: dict[int, jnp.ndarray] = {}
        method = "bdd"
        if root_bdds is not None:
            # Reuse the exact BDDs the point estimates built (uniform
            # house: one per root with shared states; non-uniform: one
            # per root with its own states) — no rebuild.
            for k, bdd in enumerate(root_bdds):
                top_trials[k] = make_bdd_evaluator(bdd)(basic_s)
        if len(top_trials) != len(live_gates):
            top_trials = {}
            method = "direct-propagation"
            if uniform_house:
                vals = propagate_probability(
                    tree, basic_s, jnp.asarray(house_rows[0]))
                for k, slot in enumerate(root_slots):
                    top_trials[k] = vals[:, slot]
            else:
                for k, (slot, hrow) in enumerate(zip(root_slots,
                                                     house_rows)):
                    vals = propagate_probability(tree, basic_s,
                                                 jnp.asarray(hrow))
                    top_trials[k] = vals[:, slot]

        out: dict[int, dict] = {}
        cursor = 0
        for k, (outcome, gate) in enumerate(zip(outcomes, gates)):
            trial = jnp.ones((n_trials,), jnp.float64)
            if init_s is not None:
                trial = trial * init_s
            for _expr in outcome.expressions:
                trial = trial * samples[:, col]
                col += 1
            if gate is not None:
                trial = trial * top_trials[cursor]
                cursor += 1
            out[k] = _summary_stats(np.asarray(trial, np.float64))
            out[k]["method"] = method if gate is not None \
                else "expression"
        return out


def _summary_stats(arr: np.ndarray) -> dict:
    lo, hi = (np.quantile(arr, [0.025, 0.975]) if len(arr) > 1
              else (arr[0], arr[0]))
    median = float(np.median(arr))
    p95 = float(np.quantile(arr, 0.95))
    return {"mean": float(arr.mean()),
            "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
            "ci95": [float(lo), float(hi)],
            "error_factor": (p95 / median if median > 0 else float("inf")),
            "n_trials": int(len(arr))}


class _FaultTreeView:
    """Minimal adapter so compile_fault_tree can anchor at a chosen top."""

    def __init__(self, name: str, top_events: list[Gate]):
        self.name = name
        self.top_events = top_events

    def collect_top_events(self):  # pragma: no cover - already collected
        pass
