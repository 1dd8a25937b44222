"""Shared test helpers: model building and brute-force oracles."""

from __future__ import annotations

import itertools

import numpy as np

from canopy_tpu.compiler.graph import compile_gates
from canopy_tpu.io.xml import Document
from canopy_tpu.mef import Initializer
from canopy_tpu.mef.event import (Arg, BasicEvent, Connective, FALSE_EVENT,
                                  Formula, Gate, HouseEvent, TRUE_EVENT)
from canopy_tpu.mef.expr import ConstantExpression
from canopy_tpu.settings import Settings


def build_model(xml: str, settings: Settings | None = None,
                allow_extern: bool = False):
    """Parse an in-memory MEF document into a validated model."""
    if settings is None:
        settings = Settings().probability_analysis(True)
    init = Initializer.from_documents([Document.from_string(xml)], settings,
                                      allow_extern=allow_extern)
    return init.model


def eval_formula(formula, state: dict[str, bool]) -> bool:
    """Scalar truth-value oracle for a formula given basic-event states."""
    values = []
    for arg in formula.args:
        event = arg.event
        if isinstance(event, Gate):
            v = eval_formula(event.formula, state)
        elif isinstance(event, HouseEvent):
            v = event.state
        else:
            v = state[event.id]
        values.append(not v if arg.complement else v)
    c = formula.connective
    n_true = sum(values)
    if c is Connective.AND:
        return all(values)
    if c is Connective.OR:
        return any(values)
    if c is Connective.NAND:
        return not all(values)
    if c is Connective.NOR:
        return not any(values)
    if c is Connective.NOT:
        return not values[0]
    if c is Connective.NULL:
        return values[0]
    if c is Connective.XOR:
        return values[0] != values[1]
    if c is Connective.IFF:
        return values[0] == values[1]
    if c is Connective.IMPLY:
        return (not values[0]) or values[1]
    if c is Connective.ATLEAST:
        return n_true >= formula.min_number
    if c is Connective.CARDINALITY:
        return formula.min_number <= n_true <= formula.max_number
    raise AssertionError(c)


def brute_force_probability(gate: Gate, basic_events: list[BasicEvent]) -> float:
    """Exact top probability by enumerating all 2^n basic-event states.

    Handles repeated events exactly (the gold standard the propagation and
    cut-set engines are checked against).
    """
    total = 0.0
    ids = [e.id for e in basic_events]
    probs = [e.p() for e in basic_events]
    for states in itertools.product([False, True], repeat=len(ids)):
        state = dict(zip(ids, states))
        if eval_formula(gate.formula, state):
            weight = 1.0
            for s, p in zip(states, probs):
                weight *= p if s else (1.0 - p)
            total += weight
    return total


def mixed_tree(n_house=1):
    """Small tree with sharing, complements, house, pair and count gates."""
    events = []
    for i, p in enumerate([0.1, 0.3, 0.5, 0.2, 0.4, 0.6, 0.25, 0.35]):
        e = BasicEvent(f"e{i}")
        e.expression = ConstantExpression(p)
        events.append(e)
    houses = []
    for i in range(n_house):
        h = HouseEvent(f"h{i}")
        h.state = bool(i % 2)
        houses.append(h)
    g1 = Gate("g1")
    g1.formula = Formula(Connective.AND, [Arg(events[0]), Arg(events[1])])
    g2 = Gate("g2")
    args2 = [Arg(events[2]), Arg(events[3], True)]
    if houses:
        args2.append(Arg(houses[0]))
    g2.formula = Formula(Connective.OR, args2)
    g3 = Gate("g3")
    g3.formula = Formula(Connective.ATLEAST,
                         [Arg(events[4]), Arg(events[5]), Arg(events[6])],
                         min_number=2)
    g4 = Gate("g4")
    g4.formula = Formula(Connective.XOR, [Arg(g1), Arg(events[7])])
    g5 = Gate("g5")  # Shares e0 with g1.
    g5.formula = Formula(Connective.OR, [Arg(events[0]), Arg(g3)])
    top = Gate("top")
    top.formula = Formula(
        Connective.OR, [Arg(g2, True), Arg(g4), Arg(g5), Arg(events[1])])
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def numpy_propagate(tree, basic_p, house_states=None) -> np.ndarray:
    """Independent float64 reference for direct propagation.

    Gate by gate in slot order with numpy over the trials axis, from the
    per-gate rows of the compiled tree: ``basic_p`` (T, n_basic) ->
    (T, n_nodes).  Count gates enumerate their argument states exactly
    (fan-in must stay small).
    """
    from canopy_tpu.compiler.graph import _emit_gate_ops
    basic_p = np.atleast_2d(np.asarray(basic_p, np.float64))
    if house_states is None:
        house_states = tree.house_state_vector()
    vals = np.zeros((basic_p.shape[0], tree.n_nodes))
    vals[:, :tree.n_basic] = basic_p
    vals[:, tree.n_basic:tree.n_basic + tree.n_house] = \
        np.asarray(house_states, np.float64)
    for kind, out, args, aux in sorted(_emit_gate_ops(tree),
                                       key=lambda row: row[1]):
        x = [1.0 - vals[:, s] if flag else vals[:, s] for s, flag in args]
        if kind == "prod":
            acc = np.prod(x, axis=0)
            vals[:, out] = 1.0 - acc if aux else acc
        elif kind == "pair":
            xor = x[0] + x[1] - 2.0 * x[0] * x[1]
            vals[:, out] = 1.0 - xor if aux else xor
        else:
            lo, hi = aux
            total = np.zeros(basic_p.shape[0])
            for states in itertools.product([0, 1], repeat=len(x)):
                if lo <= sum(states) <= hi:
                    w = np.ones(basic_p.shape[0])
                    for s, v in zip(states, x):
                        w = w * (v if s else 1.0 - v)
                    total += w
            vals[:, out] = total
    return vals
