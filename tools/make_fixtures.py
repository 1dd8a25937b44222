#!/usr/bin/env python
"""Generate Aralia-class benchmark fixtures (MEF XML + golden values).

The reference's de-facto test corpus is the Aralia fault-tree suite
(SURVEY.md §4), which is not shipped in the snapshot; these synthesized
models have the same shape (tens of gates incl. vote gates, shared basic
events, realistic probability magnitudes). Golden top-event probabilities
are computed with the exact BDD engine and cross-checked against
Monte-Carlo estimates at generation time, then frozen as regression
anchors (tests/fixtures/golden.json).

Run from the repo root:  python tools/make_fixtures.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from canopy_tpu.compiler.bdd import build_bdd  # noqa: E402
from canopy_tpu.compiler.graph import compile_gates  # noqa: E402
from canopy_tpu.engine.bdd_eval import bdd_probability  # noqa: E402
from canopy_tpu.engine.propagate import mean_basic_probabilities  # noqa: E402
from canopy_tpu.mef.event import (Arg, BasicEvent, Connective,  # noqa: E402
                                  CONNECTIVE_NAMES, Formula, Gate)
from canopy_tpu.ops.bitpack import packed_top_probability  # noqa: E402
from canopy_tpu.utils.synthetic import synthetic_mef_tree  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "tests",
                        "fixtures")


def emit_xml(name: str, top: Gate, events: list[BasicEvent]) -> str:
    """Serialize a gate DAG to MEF XML."""
    lines = ['<?xml version="1.0"?>',
             f'<opsa-mef name="{name}">',
             f'  <define-fault-tree name="{name}">']

    gates: list[Gate] = []
    seen = set()

    def collect(gate: Gate):
        if id(gate) in seen:
            return
        seen.add(id(gate))
        for arg in gate.formula.args:
            if isinstance(arg.event, Gate):
                collect(arg.event)
        gates.append(gate)

    collect(top)

    def arg_xml(arg: Arg) -> str:
        kind = "gate" if isinstance(arg.event, Gate) else "basic-event"
        inner = f'<{kind} name="{arg.event.name}"/>'
        return f"<not>{inner}</not>" if arg.complement else inner

    for gate in reversed(gates):
        formula = gate.formula
        conn = CONNECTIVE_NAMES[formula.connective]
        attrs = ""
        if formula.connective is Connective.ATLEAST:
            attrs = f' min="{formula.min_number}"'
        elif formula.connective is Connective.CARDINALITY:
            attrs = (f' min="{formula.min_number}"'
                     f' max="{formula.max_number}"')
        body = "".join(arg_xml(a) for a in formula.args)
        if formula.connective is Connective.NULL:
            inner = body
        else:
            inner = f"<{conn}{attrs}>{body}</{conn}>"
        lines.append(f'    <define-gate name="{gate.name}">{inner}'
                     f'</define-gate>')
    for event in events:
        lines.append(
            f'    <define-basic-event name="{event.name}">'
            f'<float value="{event.expression.value():.12g}"/>'
            f'</define-basic-event>')
    lines.append("  </define-fault-tree>")
    lines.append("</opsa-mef>")
    return "\n".join(lines) + "\n"


def synthetic_noncoherent_tree(n_basic: int, n_gates: int, fanin: int,
                               seed: int):
    """Layered tree with xor / complement structure (non-coherent):
    exercises the BDD's don't-care handling and the PI machinery.

    Complements appear only under AND gates and xor reads raw inputs —
    a complement under a wide OR (or xor of near-certain subtrees)
    trivializes the top to ~1.  The caller checks the top probability
    stays non-degenerate and retries seeds.
    """
    from canopy_tpu.mef.expr import ConstantExpression
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n_basic):
        e = BasicEvent(f"be{i}")
        e.expression = ConstantExpression(
            float(np.exp(rng.uniform(np.log(1e-3), np.log(0.1)))))
        events.append(e)
    pool: list = list(events)
    gates = []
    for gi in range(n_gates - 1):
        k = int(min(rng.integers(2, fanin + 2), len(pool)))
        chosen = rng.choice(len(pool), size=k, replace=False)
        gate = Gate(f"sg{gi}")
        u = rng.random()
        if u < 0.18:
            args = [Arg(pool[int(c)]) for c in chosen[:2]]
            gate.formula = Formula(Connective.XOR, args)
        elif u < 0.28 and k >= 3:
            args = [Arg(pool[int(c)]) for c in chosen]
            gate.formula = Formula(Connective.ATLEAST, args, min_number=2)
        elif u < 0.63:
            args = [Arg(pool[int(c)], bool(rng.random() < 0.25))
                    for c in chosen]
            gate.formula = Formula(Connective.AND, args)
        else:
            args = [Arg(pool[int(c)]) for c in chosen]
            gate.formula = Formula(Connective.OR, args)
        gates.append(gate)
        pool.append(gate)
    top = Gate("synthetic-top")
    roots = [g for g in gates if not g.usage] or gates[-2:]
    if len(roots) == 1:
        roots.append(gates[0] if gates[0] is not roots[0] else events[0])
    top.formula = Formula(Connective.OR, [Arg(r) for r in roots])
    return top, events


def synthetic_nested_count_tree(n_basic: int, n_gates: int, seed: int,
                                top_mode: str = "or"):
    """Deeply nested atleast/cardinality/complement tree — the hardest
    vectorization case (SURVEY.md §4.2 ranks it #1): count gates whose
    arguments are other count gates, chains many levels deep, with
    complemented arguments mixed in.  Argument selection is
    recency-biased so count-over-count chains actually form instead of
    a shallow bush."""
    from canopy_tpu.mef.expr import ConstantExpression
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n_basic):
        e = BasicEvent(f"ce{i}")
        # Mid-range probabilities: nested votes stay non-degenerate.
        e.expression = ConstantExpression(float(rng.uniform(0.05, 0.35)))
        events.append(e)
    pool: list = list(events)
    gates = []
    for gi in range(n_gates - 1):
        k = int(min(rng.integers(3, 7), len(pool)))
        idx: set[int] = set()
        while len(idx) < k:
            if rng.random() < 0.5 and len(pool) > n_basic:
                lo = max(n_basic, len(pool) - max(len(pool) // 4, 8))
                idx.add(int(rng.integers(lo, len(pool))))
            else:
                idx.add(int(rng.integers(0, len(pool))))
        args = [Arg(pool[c], bool(rng.random() < 0.15))
                for c in sorted(idx)]
        gate = Gate(f"cg{gi}")
        u = rng.random()
        if u < 0.45:
            gate.formula = Formula(Connective.ATLEAST, args,
                                   min_number=int(rng.integers(2, k)))
        elif u < 0.75:
            lo_n = int(rng.integers(1, k))
            hi_n = int(rng.integers(lo_n, k + 1))
            gate.formula = Formula(Connective.CARDINALITY, args,
                                   min_number=lo_n, max_number=hi_n)
        elif u < 0.90:
            gate.formula = Formula(Connective.AND, args)
        else:
            gate.formula = Formula(Connective.OR, args)
        gates.append(gate)
        pool.append(gate)
    top = Gate("synthetic-top")
    roots = [g for g in gates if not g.usage] or gates[-2:]
    if len(roots) == 1:
        roots.append(gates[0] if gates[0] is not roots[0] else events[0])
    # Deep vote chains saturate toward 0 or 1; the caller probes top
    # modes per seed until the top probability is non-degenerate.
    if top_mode == "or":
        top.formula = Formula(Connective.OR, [Arg(r) for r in roots])
    elif top_mode == "and":
        top.formula = Formula(Connective.AND,
                              [Arg(r) for r in roots[:3]])
    else:  # ("vote", m): ATLEAST-m over ALL roots — keeps the whole
        # gate population reachable while the threshold tunes the top
        # probability out of saturation.
        _tag, m = top_mode
        k = len(roots)
        top.formula = Formula(Connective.ATLEAST,
                              [Arg(r) for r in roots],
                              min_number=max(1, min(m, k - 1)))
    return top, events


def _count_nesting_depth(top: Gate) -> int:
    """Longest chain of count gates (atleast/cardinality) in which each
    gate is an argument of the next."""
    count_kinds = (Connective.ATLEAST, Connective.CARDINALITY)
    memo: dict[int, int] = {}

    def depth(gate: Gate) -> int:
        if id(gate) in memo:
            return memo[id(gate)]
        memo[id(gate)] = 0       # break cycles defensively
        best = 0
        for arg in gate.formula.args:
            if isinstance(arg.event, Gate):
                best = max(best, depth(arg.event))
        own = 1 if gate.formula.connective in count_kinds else 0
        memo[id(gate)] = best + own
        return memo[id(gate)]

    return depth(top)


def _nested_count_with_sane_top(n_basic, n_gates, seed,
                                min_depth: int = 8):
    """Retry seeds until the top is non-degenerate AND the count-gate
    nesting is genuinely deep."""
    from canopy_tpu.engine.propagate import top_event_probability
    for s in range(seed, seed + 50):
        # An ATLEAST-m vote over ALL roots keeps every generated gate
        # reachable; scan the threshold out of saturation first, then
        # fall back to or/and tops.
        modes = [("vote", m) for m in (2, 3, 5, 8, 12, 20, 32)] \
            + ["or", "and"]
        for mode in modes:
            top, events = synthetic_nested_count_tree(n_basic, n_gates,
                                                      s, top_mode=mode)
            depth = _count_nesting_depth(top)
            if depth < min_depth:
                break               # depth is seed-, not mode-, driven
            tree = compile_gates([top])
            tree.top_index = tree.gate_index[top.id]
            p = jnp.asarray(mean_basic_probabilities(tree))
            approx = float(top_event_probability(tree, p))
            if 1e-5 < approx < 0.9 and tree.n_gates >= 0.9 * n_gates:
                return top, events, tree, depth
    raise AssertionError("no sane nested-count seed found")


def _noncoherent_with_sane_top(n_basic, n_gates, fanin, seed):
    """Retry seeds until the top probability is non-degenerate."""
    for s in range(seed, seed + 50):
        top, events = synthetic_noncoherent_tree(n_basic, n_gates, fanin, s)
        tree = compile_gates([top])
        tree.top_index = tree.gate_index[top.id]
        p = jnp.asarray(mean_basic_probabilities(tree))
        from canopy_tpu.engine.propagate import top_event_probability
        approx = float(top_event_probability(tree, p))
        if 1e-6 < approx < 0.9:
            return top, events, tree
    raise AssertionError("no sane non-coherent seed found")


def brute_force_probability(tree, p, chunk: int = 1 << 14) -> float:
    """Exact top probability by full state enumeration — independent of
    the BDD engine (the propagation engine on 0/1 inputs is a pure
    Boolean evaluator; no Shannon recursion, no node tables)."""
    from canopy_tpu.engine.propagate import top_event_probability
    n = tree.n_basic
    assert n <= 22, "enumeration bounded to 2^22 states"
    p = np.asarray(p, dtype=np.float64)
    house = jnp.asarray(tree.house_state_vector())
    # One traced evaluation reused across all chunks (eager per-chunk
    # evaluation re-dispatches every level op — at 2^22 states x 1000
    # gates that costs tens of CPU-minutes; jitted it is seconds).
    eval_chunk = jax.jit(
        lambda bits: top_event_probability(tree, bits, house))
    total = 0.0
    for start in range(0, 1 << n, chunk):
        ids = np.arange(start, min(start + chunk, 1 << n), dtype=np.uint64)
        bits = ((ids[:, None] >> np.arange(n, dtype=np.uint64)) &
                np.uint64(1)).astype(np.float64)
        top = np.asarray(eval_chunk(jnp.asarray(bits)),
                         dtype=np.float64)
        logw = (bits * np.log(p)[None, :]
                + (1.0 - bits) * np.log1p(-p)[None, :]).sum(axis=1)
        total += float((top * np.exp(logw)).sum())
    return total


_CCF_XML = """    <define-CCF-group name="pumps-ccf" model="beta-factor">
      <members>
        <basic-event name="ccf-pump-1"/>
        <basic-event name="ccf-pump-2"/>
        <basic-event name="ccf-pump-3"/>
        <basic-event name="ccf-pump-4"/>
      </members>
      <distribution><float value="0.003"/></distribution>
      <factor level="4"><float value="0.08"/></factor>
    </define-CCF-group>
"""


def attach_ccf(xml: str, top_gate: str) -> str:
    """Wire a 4-member beta-factor CCF group into a generated tree: the
    members feed a 2-of-4 vote gate AND-ed into the top."""
    vote = ('    <define-gate name="ccf-vote">'
            '<atleast min="2">'
            '<basic-event name="ccf-pump-1"/>'
            '<basic-event name="ccf-pump-2"/>'
            '<basic-event name="ccf-pump-3"/>'
            '<basic-event name="ccf-pump-4"/>'
            '</atleast></define-gate>\n')
    wrapped = (f'    <define-gate name="plant-top">'
               f'<or><gate name="{top_gate}"/>'
               f'<gate name="ccf-vote"/></or></define-gate>\n')
    marker = "    <define-gate"
    at = xml.index(marker)
    return xml[:at] + wrapped + vote + _CCF_XML + xml[at:]


def quantify_full_stack(path: str, tree_name: str):
    """Load XML through the Initializer (CCF expansion included) and
    compile the named fault tree."""
    from canopy_tpu.compiler.graph import compile_fault_tree
    from canopy_tpu.mef import Initializer
    from canopy_tpu.settings import Settings
    settings = Settings().probability_analysis(True).ccf_analysis(True)
    model = Initializer([path], settings).model
    return compile_fault_tree(model.fault_trees.get(tree_name))


MC_TRIALS = 32 * 312_500  # 10^7 bit-packed trials.


def freeze_bdd_vs_mc(name: str, tree, golden: dict, extra=None):
    """Two independent in-repo derivations: exact BDD (Shannon node
    tables; modular Dutuit-Rauzy chain when the monolithic BDD blows
    up) vs 10^7-trial bit-packed Monte Carlo (Boolean words), frozen
    together with the 4-sigma acceptance band."""
    from canopy_tpu.compiler.bdd import BddBlowupError
    p = jnp.asarray(mean_basic_probabilities(tree))
    try:
        bdd = build_bdd(tree)
        exact = float(bdd_probability(bdd, p))
        n_bdd = bdd.n_nodes
        modular = False
    except BddBlowupError:
        from canopy_tpu.compiler.modules import (build_modular_bdd,
                                                 modular_probability)
        mb = build_modular_bdd(tree)
        exact = float(modular_probability(mb, p))
        n_bdd = sum(b.n_nodes for b, _s in mb.chain)
        modular = True
    mc = float(packed_top_probability(
        tree, jax.random.PRNGKey(0), p, MC_TRIALS))
    stderr = float(np.sqrt(exact * (1 - exact) / MC_TRIALS))
    assert abs(mc - exact) < max(4 * stderr, 1e-9), (name, exact, mc)
    kind = "modular BDD (Dutuit-Rauzy chain)" if modular \
        else "BDD (Shannon)"
    golden[name] = {
        "top_event": "synthetic-top",
        "exact_probability": exact,
        "mc_estimate": mc,
        "mc_trials": MC_TRIALS,
        "mc_4sigma": 4 * stderr,
        "derivation": f"{kind} vs 1e7-trial bit-packed MC, "
                      "independent engines, 4-sigma agreement",
        "n_basic": tree.n_basic,
        "n_gates": tree.n_gates,
        "nnz": tree.nnz,
        "bdd_nodes": n_bdd,
        "modular": modular,
    }
    if extra:
        golden[name].update(extra)
    print(f"{name}: P={exact:.8e} (MC {mc:.4e} +-{stderr:.1e}) "
          f"gates={tree.n_gates} bdd={n_bdd}{' modular' if modular else ''}")


_SUBSTITUTION_XML = """<?xml version="1.0"?>
<opsa-mef name="aralia_like_substitution">
  <!-- Hand-computable: top = a(b OR d) OR c.
       MCS before substitution: {a,b}, {a,d}, {c}.
       delete-terms on hypothesis (a AND b) removes {a,b}. -->
  <define-fault-tree name="aralia_like_substitution">
    <define-gate name="sub-top">
      <or><gate name="and1"/><gate name="and2"/>
          <basic-event name="c"/></or>
    </define-gate>
    <define-gate name="and1">
      <and><basic-event name="a"/><basic-event name="b"/></and>
    </define-gate>
    <define-gate name="and2">
      <and><basic-event name="a"/><basic-event name="d"/></and>
    </define-gate>
    <define-basic-event name="a"><float value="0.1"/></define-basic-event>
    <define-basic-event name="b"><float value="0.2"/></define-basic-event>
    <define-basic-event name="c"><float value="0.05"/></define-basic-event>
    <define-basic-event name="d"><float value="0.3"/></define-basic-event>
  </define-fault-tree>
  <define-substitution name="maintenance-exclusion" type="delete-terms">
    <hypothesis>
      <and><basic-event name="a"/><basic-event name="b"/></and>
    </hypothesis>
    <target><constant value="false"/></target>
  </define-substitution>
</opsa-mef>
"""


def freeze_substitution_golden(golden: dict) -> None:
    from canopy_tpu.engine.analysis import RiskAnalysis
    from canopy_tpu.mef import Initializer
    from canopy_tpu.settings import Settings

    name = "aralia_like_substitution"
    path = os.path.join(FIXTURES, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write(_SUBSTITUTION_XML)
    # Hand arithmetic: P(top) = 1 - (1 - P(a)(1-(1-P(b))(1-P(d))))(1-P(c))
    a, b, c, d = 0.1, 0.2, 0.05, 0.3
    exact = 1.0 - (1.0 - a * (1.0 - (1.0 - b) * (1.0 - d))) * (1.0 - c)
    products_after = sorted([sorted(["a", "d"]), ["c"]])
    # Full-stack cross-check at freeze time.
    settings = Settings().probability_analysis(True)
    model = Initializer([path], settings).model
    report = RiskAnalysis(model, settings).run()
    res = report.fault_trees[0]
    assert abs(res.probability - exact) < 1e-12, (res.probability, exact)
    got = sorted(sorted(names) for _o, _q, names in res.products)
    assert got == products_after, got
    golden[name] = {
        "top_event": "sub-top",
        "exact_probability": exact,
        "n_products_after_substitution": 2,
        "products_after_substitution": products_after,
        "substitution": "delete-terms on (a AND b)",
        "derivation": "hand-derived: MCS {a,b},{a,d},{c}; delete-terms "
                      "removes {a,b}; P = 1-(1-a(1-(1-b)(1-d)))(1-c); "
                      "cross-checked through the full analysis stack",
        "kind": "substitution",
    }
    print(f"{name}: P={exact:.12e}, products after = {products_after}")


_ALIGNMENT_XML = """<?xml version="1.0"?>
<opsa-mef name="aralia_like_alignment">
  <!-- Hand-computable: top = (p1 AND p2) OR (maint AND valve);
       exponential basics, mission 8760 h (the default).  Phase "run"
       (0.6, 5256 h): maint false -> P = (1-e^-la*5256)^2.  Phase
       "service" (0.4, 3504 h): maint true
       -> P = 1-(1-(1-e^-la*3504)^2)(1-(1-e^-lv*3504)). -->
  <define-fault-tree name="aralia_like_alignment">
    <define-gate name="al-top">
      <or><gate name="pumps"/><gate name="maint-line"/></or>
    </define-gate>
    <define-gate name="pumps">
      <and><basic-event name="p1"/><basic-event name="p2"/></and>
    </define-gate>
    <define-gate name="maint-line">
      <and><house-event name="maint"/><basic-event name="valve"/></and>
    </define-gate>
    <define-basic-event name="p1">
      <exponential><float value="1.0e-4"/><system-mission-time/>
      </exponential>
    </define-basic-event>
    <define-basic-event name="p2">
      <exponential><float value="1.0e-4"/><system-mission-time/>
      </exponential>
    </define-basic-event>
    <define-basic-event name="valve">
      <exponential><float value="1.0e-3"/><system-mission-time/>
      </exponential>
    </define-basic-event>
    <define-house-event name="maint"><constant value="false"/>
    </define-house-event>
  </define-fault-tree>
  <define-alignment name="duty">
    <define-phase name="run" time-fraction="0.6"/>
    <define-phase name="service" time-fraction="0.4">
      <set-house-event name="maint"><constant value="true"/>
      </set-house-event>
    </define-phase>
  </define-alignment>
</opsa-mef>
"""


def freeze_alignment_golden(golden: dict) -> None:
    import math

    from canopy_tpu.engine.analysis import RiskAnalysis
    from canopy_tpu.mef import Initializer
    from canopy_tpu.settings import Settings

    name = "aralia_like_alignment"
    path = os.path.join(FIXTURES, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write(_ALIGNMENT_XML)
    mission = 8760.0
    la, lv = 1.0e-4, 1.0e-3
    def q(lam, t):
        return 1.0 - math.exp(-lam * t)
    m_run, m_srv = mission * 0.6, mission * 0.4
    p_run = q(la, m_run) ** 2
    p_srv = 1.0 - (1.0 - q(la, m_srv) ** 2) * (1.0 - q(lv, m_srv))
    settings = Settings().probability_analysis(True)
    model = Initializer([path], settings).model
    report = RiskAnalysis(model, settings).run()
    phases = {r.phase: r.probability for r in report.fault_trees
              if r.alignment == "duty"}
    assert abs(phases["run"] - p_run) < 1e-12, (phases["run"], p_run)
    assert abs(phases["service"] - p_srv) < 1e-12, (phases["service"],
                                                    p_srv)
    golden[name] = {
        "top_event": "al-top",
        "mission_time": mission,
        "phases": {"run": p_run, "service": p_srv},
        "derivation": "hand-derived closed form per phase (exponential "
                      "basics at mission*fraction, house event flipped "
                      "in 'service'); cross-checked through the batched "
                      "phase analysis",
        "kind": "alignment",
    }
    print(f"{name}: run={p_run:.12e} service={p_srv:.12e}")


#: Recorded 1e7-trial bit-packed MC for the plant anchor, run on an
#: NVIDIA H100 by ``chip_smoke.py``: 10,002,432 trials of the packed
#: engine in 1,221 chunks of 8,192, chunk ``i`` keyed
#: ``fold_in(PRNGKey(7), i)``.  ``packed_top_probability`` now sizes its
#: chunks from the event count (4,096 trials for 65,536 events), so it
#: draws other numbers for the same key.  The sampler draws a
#: (trials, 65536) float matrix per chunk, so the full run is a GPU job
#: (a day on a CPU) — the freezer cross-checks the CPU-computed exact
#: BDD value against this recorded estimate.
_PLANT_MC = dict(estimate=0.9872997886913902, trials=10_002_432,
                 provenance="NVIDIA H100 80GB HBM3, chip_smoke.py: "
                            "bit-packed MC, 1,221 chunks of 8,192 trials "
                            "keyed fold_in(PRNGKey(7), chunk)")


def freeze_plant_golden(golden: dict) -> None:
    from canopy_tpu.compiler.modules import (build_modular_bdd,
                                             modular_probability)
    from canopy_tpu.utils.synthetic import synthetic_hierarchical_tree

    name = "plant_hier_9363"
    # The bench criterion shape (9,363 gates, branching 8) with
    # module-local sharing: the bench tree's 128 globally-sprinkled
    # shared events defeat ANY exact method by design (monolithic and
    # modular BDDs both blow past 50M nodes — measured), so the exact
    # plant-scale anchor uses the quantifiable sharing variant.
    cfg = dict(n_basic=65536, branching=8, share_fraction=0.04,
               n_shared=32, seed=0)
    tree = synthetic_hierarchical_tree(**cfg)
    rng = np.random.default_rng(42)
    p = jnp.asarray(rng.uniform(1e-4, 5e-3, tree.n_basic))
    mb = build_modular_bdd(tree, max_nodes=50_000_000)
    exact = float(modular_probability(mb, p))
    mc = _PLANT_MC["estimate"]
    total = _PLANT_MC["trials"]
    stderr = float(np.sqrt(exact * (1 - exact) / total))
    assert abs(mc - exact) < max(4 * stderr, 1e-9), (exact, mc)
    golden[name] = {
        "kind": "plant_synthetic",
        "generator": cfg,
        "probability_recipe": "default_rng(42).uniform(1e-4, 5e-3, "
                              "n_basic)",
        "exact_probability": exact,
        "mc_estimate": mc,
        "mc_trials": total,
        "mc_4sigma": 4 * stderr,
        "mc_provenance": _PLANT_MC["provenance"],
        "n_gates": tree.n_gates,
        "nnz": tree.nnz,
        "bdd_nodes": mb.total_nodes,
        "modules": len(mb.chain),
        "derivation": "modular (Dutuit-Rauzy) exact BDD vs 1e7-trial "
                      "bit-packed MC (recorded GPU run) on the 9,363-gate "
                      "hierarchical plant tree",
    }
    print(f"{name}: P={exact:.10e} (MC {mc:.4e} +-{stderr:.1e}) "
          f"gates={tree.n_gates} modules={len(mb.chain)} "
          f"bdd={mb.total_nodes}")


def freeze_nested_count_golden(golden: dict) -> None:
    """Deep nested-count anchor: BDD vs 2^22 enumeration vs MC."""
    top, events, tree, depth = _nested_count_with_sane_top(
        n_basic=22, n_gates=1000, seed=606)
    name = "aralia_like_nested_count"
    with open(os.path.join(FIXTURES, f"{name}.xml"), "w") as fh:
        fh.write(emit_xml(name, top, events))
    n_count = sum(
        1 for g in tree.gates
        if g.formula.connective in (Connective.ATLEAST,
                                    Connective.CARDINALITY))
    p = mean_basic_probabilities(tree)
    # The unique/memo forest peaks far above the final BDD while
    # composing 1000 deeply nested vote gates (the final canonical BDD
    # over 22 variables is ~112k nodes).
    bdd = build_bdd(tree, max_nodes=60_000_000)
    exact = float(bdd_probability(bdd, jnp.asarray(p)))
    brute = brute_force_probability(tree, p)
    assert abs(brute - exact) < 1e-9, (brute, exact)
    mc = float(packed_top_probability(
        tree, jax.random.PRNGKey(0), jnp.asarray(p), MC_TRIALS))
    stderr = float(np.sqrt(exact * (1 - exact) / MC_TRIALS))
    assert abs(mc - exact) < 4 * stderr, (exact, mc)
    golden[name] = {
        "top_event": "synthetic-top",
        "exact_probability": exact,
        "brute_force_probability": brute,
        "mc_estimate": mc,
        "mc_trials": MC_TRIALS,
        "mc_4sigma": 4 * stderr,
        "derivation": "exact BDD vs full 2^22 state enumeration "
                      "(agreement < 1e-9) vs 1e7-trial bit-packed MC "
                      "(4-sigma); deep atleast/cardinality nesting — "
                      "the hardest vectorization case (SURVEY.md §4.2)",
        "coherent": False,
        "n_basic": tree.n_basic, "n_gates": tree.n_gates,
        "nnz": tree.nnz, "bdd_nodes": bdd.n_nodes,
        "bdd_max_nodes": 60_000_000,
        "count_gates": n_count,
        "count_nesting_depth": depth,
    }
    print(f"{name}: P={exact:.8e} (brute {brute:.8e}, MC {mc:.4e}) "
          f"depth={depth} count_gates={n_count} bdd={bdd.n_nodes}")


def main() -> None:
    golden = {}
    configs = [
        ("aralia_like_small", dict(n_basic=40, n_gates=30, fanin=3,
                                   seed=101, atleast_fraction=0.15)),
        ("aralia_like_medium", dict(n_basic=120, n_gates=90, fanin=4,
                                    seed=202, atleast_fraction=0.1)),
        ("aralia_like_large", dict(n_basic=260, n_gates=500, fanin=3,
                                   seed=700, atleast_fraction=0.08,
                                   complement_fraction=0.04)),
    ]
    for name, kw in configs:
        top, events = synthetic_mef_tree(**kw)
        tree = compile_gates([top])
        tree.top_index = tree.gate_index[top.id]
        xml = emit_xml(name, top, events)
        with open(os.path.join(FIXTURES, f"{name}.xml"), "w") as fh:
            fh.write(xml)
        extra = {"cutset_check": False} if name == "aralia_like_large" \
            else None   # limit-order truncation voids the bound check
        freeze_bdd_vs_mc(name, tree, golden, extra=extra)

    # Non-coherent corpus entry (xor/complements): same two engines.
    top, events, tree = _noncoherent_with_sane_top(n_basic=60, n_gates=120,
                                                   fanin=3, seed=404)
    name = "aralia_like_noncoherent"
    with open(os.path.join(FIXTURES, f"{name}.xml"), "w") as fh:
        fh.write(emit_xml(name, top, events))
    freeze_bdd_vs_mc(name, tree, golden, extra={"coherent": False})

    # CCF entry: quantified through the FULL stack (XML -> initializer
    # -> beta-factor expansion -> compile), BDD vs MC.
    top, events = synthetic_mef_tree(n_basic=80, n_gates=60, fanin=3,
                                     seed=303, atleast_fraction=0.1)
    name = "aralia_like_ccf"
    xml = emit_xml(name, top, events)
    xml = attach_ccf(xml, top.id)
    path = os.path.join(FIXTURES, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write(xml)
    tree = quantify_full_stack(path, name)
    freeze_bdd_vs_mc(name, tree, golden,
                     extra={"top_event": "plant-top", "ccf": True})

    # Deep atleast/cardinality nesting anchor (VERDICT r4 item 9): the
    # hardest vectorization case — 1k gates of count-over-count chains
    # (nesting depth 60) with complemented arguments over only 22
    # basics, so sharing is extreme (~180 reads/basic; direct
    # propagation is off by ~30% — the anchor really exercises the
    # exact path) and THREE independent derivations are possible:
    # exact BDD, full 2^22 state enumeration through the propagation
    # engine, and 1e7-trial bit-packed MC.
    freeze_nested_count_golden(golden)

    # Brute-force anchor: full 2^n_basic enumeration (no BDD involvement)
    # vs the BDD — the strongest independence in the corpus.
    top, events, tree = _noncoherent_with_sane_top(n_basic=18, n_gates=36,
                                                   fanin=3, seed=505)
    name = "brute_noncoherent"
    with open(os.path.join(FIXTURES, f"{name}.xml"), "w") as fh:
        fh.write(emit_xml(name, top, events))
    p = mean_basic_probabilities(tree)
    brute = brute_force_probability(tree, p)
    bdd = build_bdd(tree)
    exact = float(bdd_probability(bdd, jnp.asarray(p)))
    assert abs(brute - exact) < 1e-11, (brute, exact)
    golden[name] = {
        "top_event": top.id,
        "exact_probability": brute,
        "bdd_probability": exact,
        "coherent": False,
        "derivation": f"full 2^{tree.n_basic} state enumeration "
                      "through the propagation engine (no BDD) vs "
                      "exact BDD; agreement < 1e-11",
        "n_basic": tree.n_basic, "n_gates": tree.n_gates,
        "nnz": tree.nnz, "bdd_nodes": bdd.n_nodes,
    }
    print(f"{name}: P={brute:.12e} (BDD {exact:.12e})")

    # Substitution-bearing golden: hand-computable model, hand-derived
    # product set before/after the delete-terms substitution, exact
    # probability by closed form — cross-checked through the full
    # analysis stack at freeze time.
    freeze_substitution_golden(golden)

    # Alignment-bearing golden: per-phase probabilities by closed form
    # (exponential basics, a phase-flipped house event) — cross-checked
    # through the batched phase analysis at freeze time.
    freeze_alignment_golden(golden)

    # Plant-scale anchor: the 9,363-gate hierarchical tree, BDD-exact
    # vs 1e7-trial bit-packed MC.  Synthetic compiled-only model: the golden records the
    # generator config instead of an XML file.
    freeze_plant_golden(golden)

    # Hand-computed event-tree plant (tests/fixtures/hand_event_tree.xml
    # is authored by hand; the sequence values below are pencil-and-
    # paper products — see the XML comments for the arithmetic).
    golden["hand_event_tree"] = {
        "kind": "event_tree",
        "initiating_event": "LOSP",
        "derivation": "hand-computed: P(cooling)=1-0.9*0.8=0.28, "
                      "P(power)=0.5*0.4=0.2, independent events; "
                      "sequence = P(losp-occurs)=0.01 * branch "
                      "products (all collect-formula, homogeneous)",
        "sequences": {
            "OK": 0.01 * (1 - 0.28),
            "PartialDamage": 0.01 * 0.28 * (1 - 0.2),
            "CoreDamage": 0.01 * 0.28 * 0.2,
        },
    }

    with open(os.path.join(FIXTURES, "golden.json"), "w") as fh:
        json.dump(golden, fh, indent=2)


if __name__ == "__main__":
    main()
