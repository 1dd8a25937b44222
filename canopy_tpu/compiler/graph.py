"""Gate-graph compiler: MEF formulas -> level-scheduled array blocks.

This is the bridge between the front-end object model and the device engines,
replacing the reference's absent ``src/bool/bool`` evaluation engine
(SURVEY.md §2.6) with a design chosen for XLA:

* Every event gets a slot in one dense **value vector**: basic events
  first, then house events, then gates. Gate arguments index into this
  vector, so bottom-up propagation is a sequence of gathers + reductions —
  the CSR SpMV access pattern, laid out statically at compile time.
* Gates are **level-scheduled** (level = 1 + max level of gate args; the
  initializer's cycle check guarantees a DAG), so each level is one
  data-parallel batch with static shapes — no data-dependent control flow
  reaches XLA.
* Within a level, gates are canonicalized into three **families**:

  - ``prod`` — and/or/nand/nor/null/not/imply, all reduced to one fused
    form ``out = inv_out XOR prod(inv_in XOR neg XOR arg)`` via De Morgan
    (in probability space: ``x -> 1-x`` for each inversion). One padded
    gather + product-reduce evaluates every such gate in the level.
  - ``pair`` — xor/iff (exactly two arguments).
  - ``count`` — atleast/cardinality, evaluated with a vectorized
    Poisson-binomial dynamic program over the padded argument axis with an
    absorbing count cap (exact, no combinatorial expansion).

* Padding within a family uses the family's neutral element, so the
  compute is mask-free on the hot path (``prod`` pads with 1 after
  inversion handling; ``count`` pads with probability 0).

Complement edges are carried as per-argument flags (the ``neg`` bit), so
non-coherent trees cost nothing extra. House events are *inputs*, not
compile-time constants: event-tree walks, alignment phases, and
substitution hypotheses flip them per analysis without recompiling.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from ..errors import LogicError
from ..mef.event import (BasicEvent, Connective, FALSE_EVENT, Formula, Gate,
                         HouseEvent, TRUE_EVENT)

__all__ = ["CompiledTree", "LevelBlock", "ProdBlock", "PairBlock",
           "CountBlock", "compile_fault_tree", "compile_gates",
           "merge_prod_level"]

_PROD_FAMILY = {Connective.AND, Connective.OR, Connective.NAND,
                Connective.NOR, Connective.NULL, Connective.NOT,
                Connective.IMPLY}
_PAIR_FAMILY = {Connective.XOR, Connective.IFF}
_COUNT_FAMILY = {Connective.ATLEAST, Connective.CARDINALITY}


@dataclasses.dataclass
class ProdBlock:
    """Product-family gates of one level (padded ELL layout)."""

    out_idx: np.ndarray   # (G,) int32 value-vector slots of the gates
    arg_idx: np.ndarray   # (G, F) int32 argument slots (padded with 0)
    arg_flip: np.ndarray  # (G, F) bool: inv_in XOR complement, pre-fused
    arg_mask: np.ndarray  # (G, F) bool: real vs padding
    inv_out: np.ndarray   # (G,) bool: complement the product

    @property
    def n_gates(self) -> int:
        return len(self.out_idx)

    @property
    def nnz(self) -> int:
        return int(self.arg_mask.sum())


@dataclasses.dataclass
class PairBlock:
    """xor/iff gates of one level."""

    out_idx: np.ndarray   # (G,)
    arg_idx: np.ndarray   # (G, 2)
    arg_neg: np.ndarray   # (G, 2) complement flags
    is_iff: np.ndarray    # (G,) bool: iff = not xor

    @property
    def n_gates(self) -> int:
        return len(self.out_idx)

    @property
    def nnz(self) -> int:
        return 2 * len(self.out_idx)


@dataclasses.dataclass
class CountBlock:
    """atleast/cardinality gates of one level (Poisson-binomial DP)."""

    out_idx: np.ndarray   # (G,)
    arg_idx: np.ndarray   # (G, F)
    arg_neg: np.ndarray   # (G, F)
    arg_mask: np.ndarray  # (G, F)
    min_num: np.ndarray   # (G,) lower count bound (inclusive)
    max_num: np.ndarray   # (G,) upper count bound (inclusive)
    cap: int              # DP absorbing cap: max(max_num) + 1

    @property
    def n_gates(self) -> int:
        return len(self.out_idx)

    @property
    def nnz(self) -> int:
        return int(self.arg_mask.sum())


@dataclasses.dataclass
class LevelBlock:
    """One dependency level: product-family blocks bucketed by fan-in
    (power-of-two buckets, so ragged levels pad at most 2x within each
    bucket instead of to the level's max fan-in), plus pair/count."""

    prods: list[ProdBlock]
    pairs: list[PairBlock]
    counts: list[CountBlock]

    def iter_blocks(self):
        for b in self.prods:
            yield ("prod", b)
        for b in self.pairs:
            yield ("pair", b)
        for b in self.counts:
            yield ("count", b)

    @property
    def nnz(self) -> int:
        return sum(b.nnz for _, b in self.iter_blocks())


@dataclasses.dataclass
class CompiledTree:
    """A fault tree (or gate set) compiled to array form.

    The value vector layout is ``[basic events | house events | gates]``.
    """

    n_basic: int
    n_house: int
    n_gates: int
    basic_index: dict[str, int]          # basic-event id -> slot
    house_index: dict[str, int]          # house-event id -> slot
    gate_index: dict[str, int]           # gate id -> slot
    levels: list[LevelBlock]
    basic_events: list[BasicEvent]       # slot-ordered
    house_events: list[HouseEvent]       # slot-ordered
    gates: list[Gate]                    # slot-ordered (by value slot)
    top_index: int | None = None         # slot of the tree's top gate

    @property
    def n_nodes(self) -> int:
        return self.n_basic + self.n_house + self.n_gates

    @property
    def nnz(self) -> int:
        """Total structural nonzeros (argument edges) across all levels."""
        return sum(level.nnz for level in self.levels)

    @property
    def depth(self) -> int:
        return len(self.levels)

    def house_state_vector(self) -> np.ndarray:
        """Current house-event states as a float vector."""
        return np.array([1.0 if h.state else 0.0 for h in self.house_events],
                        dtype=np.float64)


def _gather_reachable(roots: Iterable[Gate], ccf: bool):
    """Collect gates/basic/house events reachable from the roots.

    Iterative post-order DFS (args before gate) — no recursion limit, so
    million-gate synthetic trees compile fine. When ``ccf`` is set,
    CCF-expanded members are replaced by their proxy gates.
    """
    seen: set[int] = set()
    basics: dict[int, BasicEvent] = {}
    houses: dict[int, HouseEvent] = {}
    order: list[Gate] = []

    stack: list[tuple[Gate, bool]] = [(root, False) for root in
                                      reversed(list(roots))]
    while stack:
        gate, expanded = stack.pop()
        if expanded:
            order.append(gate)
            continue
        if id(gate) in seen:
            continue
        seen.add(id(gate))
        if gate.formula is None:
            raise LogicError(f"Gate '{gate.id}' has no formula.")
        stack.append((gate, True))
        for arg in gate.formula.args:
            event = arg.event
            if isinstance(event, BasicEvent) and event.has_ccf and ccf:
                event = event.ccf_gate
            if isinstance(event, Gate):
                if id(event) not in seen:
                    stack.append((event, False))
            elif isinstance(event, BasicEvent):
                basics.setdefault(id(event), event)
            elif isinstance(event, HouseEvent):
                houses.setdefault(id(event), event)
    return order, list(basics.values()), list(houses.values())


def _resolve_slot(event, basic_slot, house_slot, gate_slot) -> int:
    """Slot lookup after CCF indirection has already been applied."""
    if isinstance(event, Gate):
        return gate_slot[id(event)]
    if isinstance(event, BasicEvent):
        return basic_slot[id(event)]
    return house_slot[id(event)]


def compile_gates(roots: list[Gate], use_ccf: bool = True) -> CompiledTree:
    """Compile the gate DAG reachable from ``roots`` into level blocks.

    ``use_ccf=False`` ignores CCF proxy gates and keeps the original basic
    events (mirrors analyses run without ``--ccf``).
    """
    return _compile(roots, ccf=use_ccf)


def _compile(roots: list[Gate], ccf: bool) -> CompiledTree:
    gate_order, basics, houses = _gather_reachable(roots, ccf)

    basics.sort(key=lambda e: e.id)
    houses.sort(key=lambda e: e.id)
    basic_slot = {id(e): i for i, e in enumerate(basics)}
    n_basic = len(basics)
    house_slot = {id(e): n_basic + i for i, e in enumerate(houses)}
    n_house = len(houses)

    # Level assignment: level(gate) = 1 + max level of its gate args.
    level_of: dict[int, int] = {}
    for gate in gate_order:  # Post-order guarantees args first.
        max_arg = 0
        for arg in gate.formula.args:
            event = arg.event
            if isinstance(event, BasicEvent) and event.has_ccf and ccf:
                event = event.ccf_gate
            if isinstance(event, Gate):
                max_arg = max(max_arg, level_of[id(event)])
        level_of[id(gate)] = max_arg + 1

    n_levels = max(level_of.values(), default=0)
    gate_slot: dict[int, int] = {}
    slot_ordered_gates: list[Gate] = []
    next_slot = n_basic + n_house
    by_level: list[list[Gate]] = [[] for _ in range(n_levels)]
    for gate in gate_order:
        by_level[level_of[id(gate)] - 1].append(gate)

    def _bucket(n_args: int) -> int:
        bucket = 1
        while bucket < n_args:
            bucket *= 2
        return bucket

    def family_rank(gate: Gate) -> tuple[int, int]:
        c = gate.formula.connective
        if c in _PROD_FAMILY:
            return (0, _bucket(len(gate.formula.args)))
        if c in _PAIR_FAMILY:
            return (1, 2)
        return (2, _bucket(len(gate.formula.args)))

    for level_gates in by_level:
        # Deterministic order; family-grouped so each block's output
        # slots form one contiguous range (the engine then writes levels
        # with dynamic-update-slice instead of scatter).
        level_gates.sort(key=lambda g: (*family_rank(g), g.id))
        for gate in level_gates:
            gate_slot[id(gate)] = next_slot
            slot_ordered_gates.append(gate)
            next_slot += 1

    def slot(event) -> int:
        if isinstance(event, BasicEvent) and event.has_ccf and ccf:
            event = event.ccf_gate
        return _resolve_slot(event, basic_slot, house_slot, gate_slot)

    levels: list[LevelBlock] = []
    for level_gates in by_level:
        prod_buckets: dict[int, list] = {}
        pair_rows, count_rows = [], []
        for gate in level_gates:
            formula = gate.formula
            c = formula.connective
            row = (gate, formula)
            if c in _PROD_FAMILY:
                prod_buckets.setdefault(
                    _bucket(len(formula.args)), []).append(row)
            elif c in _PAIR_FAMILY:
                pair_rows.append(row)
            else:
                count_rows.append(row)
        levels.append(LevelBlock(
            prods=[_build_prod(rows, gate_slot, slot)
                   for _, rows in sorted(prod_buckets.items())],
            pairs=[_build_pair(pair_rows, gate_slot, slot)]
            if pair_rows else [],
            counts=[_build_count(count_rows, gate_slot, slot)]
            if count_rows else []))

    return CompiledTree(
        n_basic=n_basic, n_house=n_house, n_gates=len(slot_ordered_gates),
        basic_index={e.id: basic_slot[id(e)] for e in basics},
        house_index={e.id: house_slot[id(e)] for e in houses},
        gate_index={g.id: gate_slot[id(g)] for g in slot_ordered_gates},
        levels=levels, basic_events=basics, house_events=houses,
        gates=slot_ordered_gates)


def _build_prod(rows, gate_slot, slot) -> ProdBlock:
    n = len(rows)
    fan = max(len(f.args) for _, f in rows)
    out_idx = np.zeros(n, dtype=np.int32)
    arg_idx = np.zeros((n, fan), dtype=np.int32)
    arg_flip = np.zeros((n, fan), dtype=bool)
    arg_mask = np.zeros((n, fan), dtype=bool)
    inv_out = np.zeros(n, dtype=bool)
    for i, (gate, formula) in enumerate(rows):
        c = formula.connective
        # De Morgan canonicalization (see module docstring).
        inv_in = c in (Connective.OR, Connective.NOR, Connective.IMPLY)
        inv_out[i] = c in (Connective.OR, Connective.NAND, Connective.IMPLY)
        out_idx[i] = gate_slot[id(gate)]
        for j, arg in enumerate(formula.args):
            neg = arg.complement or (c is Connective.NOT)
            if c is Connective.IMPLY and j == 0:
                neg = not neg  # imply(a, b) == or(not a, b)
            arg_idx[i, j] = slot(arg.event)
            arg_flip[i, j] = inv_in != neg
            arg_mask[i, j] = True
    return ProdBlock(out_idx, arg_idx, arg_flip, arg_mask, inv_out)


def _build_pair(rows, gate_slot, slot) -> PairBlock:
    n = len(rows)
    out_idx = np.zeros(n, dtype=np.int32)
    arg_idx = np.zeros((n, 2), dtype=np.int32)
    arg_neg = np.zeros((n, 2), dtype=bool)
    is_iff = np.zeros(n, dtype=bool)
    for i, (gate, formula) in enumerate(rows):
        out_idx[i] = gate_slot[id(gate)]
        is_iff[i] = formula.connective is Connective.IFF
        for j, arg in enumerate(formula.args):
            arg_idx[i, j] = slot(arg.event)
            arg_neg[i, j] = arg.complement
    return PairBlock(out_idx, arg_idx, arg_neg, is_iff)


def _build_count(rows, gate_slot, slot) -> CountBlock:
    n = len(rows)
    fan = max(len(f.args) for _, f in rows)
    out_idx = np.zeros(n, dtype=np.int32)
    arg_idx = np.zeros((n, fan), dtype=np.int32)
    arg_neg = np.zeros((n, fan), dtype=bool)
    arg_mask = np.zeros((n, fan), dtype=bool)
    min_num = np.zeros(n, dtype=np.int32)
    max_num = np.zeros(n, dtype=np.int32)
    for i, (gate, formula) in enumerate(rows):
        out_idx[i] = gate_slot[id(gate)]
        n_args = len(formula.args)
        if formula.connective is Connective.ATLEAST:
            min_num[i] = formula.min_number
            max_num[i] = n_args
        else:  # CARDINALITY
            min_num[i] = formula.min_number
            max_num[i] = formula.max_number
        for j, arg in enumerate(formula.args):
            arg_idx[i, j] = slot(arg.event)
            arg_neg[i, j] = arg.complement
            arg_mask[i, j] = True
    cap = int(max_num.max()) + 1
    return CountBlock(out_idx, arg_idx, arg_neg, arg_mask, min_num, max_num,
                      cap)


def merge_prod_level(level: LevelBlock) -> ProdBlock:
    """Merge a level's fan-in-bucketed prod blocks into one padded ELL
    block (rows stay slot-ordered; the level's output range stays
    contiguous).  Raises for pair/count levels — callers that need the
    prod-only fast path (BSR, pipeline) share this.
    """
    if level.pairs or level.counts:
        raise LogicError("level contains non-product-family gates")
    blocks = [b for b in level.prods if b.n_gates]
    if not blocks:
        raise LogicError("level has no gates")
    fan = max(b.arg_idx.shape[1] for b in blocks)
    n = sum(b.n_gates for b in blocks)
    out_start = min(int(b.out_idx[0]) for b in blocks)
    arg_idx = np.zeros((n, fan), dtype=np.int32)
    arg_flip = np.zeros((n, fan), dtype=bool)
    arg_mask = np.zeros((n, fan), dtype=bool)
    inv_out = np.zeros(n, dtype=bool)
    for b in blocks:
        rows = b.out_idx.astype(np.int64) - out_start
        f = b.arg_idx.shape[1]
        arg_idx[rows, :f] = b.arg_idx
        arg_flip[rows, :f] = b.arg_flip
        arg_mask[rows, :f] = b.arg_mask
        inv_out[rows] = b.inv_out
    return ProdBlock(
        out_idx=np.arange(out_start, out_start + n, dtype=np.int32),
        arg_idx=arg_idx, arg_flip=arg_flip, arg_mask=arg_mask,
        inv_out=inv_out)


def _emit_gate_ops(tree: CompiledTree):
    """Per-gate ``(kind, out_slot, args, aux)`` rows from the level blocks.

    ``args`` is a list of ``(slot, flag)`` in formula order (padding
    dropped); ``aux`` is ``inv_out`` for ``prod``, ``is_iff`` for
    ``pair`` and the ``(min, max)`` count window for ``count``.  Used to
    rebuild gate semantics for array-backed trees that carry no MEF gate
    objects (BDD construction, module detection).
    """
    ops = []
    for level in tree.levels:
        for kind, b in level.iter_blocks():
            if kind == "prod":
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_flip[g, f]))
                            for f in range(b.arg_idx.shape[1])
                            if b.arg_mask[g, f]]
                    ops.append(("prod", int(b.out_idx[g]), args,
                                bool(b.inv_out[g])))
            elif kind == "pair":
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_neg[g, f]))
                            for f in range(2)]
                    ops.append(("pair", int(b.out_idx[g]), args,
                                bool(b.is_iff[g])))
            else:
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_neg[g, f]))
                            for f in range(b.arg_idx.shape[1])
                            if b.arg_mask[g, f]]
                    ops.append(("count", int(b.out_idx[g]), args,
                                (int(b.min_num[g]), int(b.max_num[g]))))
    return ops


def compile_fault_tree(fault_tree, top: Gate | None = None,
                       use_ccf: bool = True) -> CompiledTree:
    """Compile one fault tree, anchored at ``top`` (default: its first
    detected top event)."""
    if top is None:
        if not fault_tree.top_events:
            fault_tree.collect_top_events()
        if not fault_tree.top_events:
            raise LogicError(
                f"Fault tree '{fault_tree.name}' has no top events.")
        top = fault_tree.top_events[0]
    compiled = compile_gates([top], use_ccf=use_ccf)
    compiled.top_index = compiled.gate_index[top.id]
    return compiled


def prune_to_top_cone(tree: CompiledTree) -> CompiledTree:
    """A new CompiledTree containing only the top event's ancestor cone.

    Basic/house slots are untouched; gates outside the cone are dropped
    and the rest re-numbered in (level, block, row) order, which keeps
    every block's output range contiguous (the engines'
    dynamic-update-slice invariant) and args-before-gates topology.
    Top-only queries on large models skip the dead gates entirely (on
    the 1M-gate uniform synthetic the cone is a few percent of the
    gates).  Per-gate argument lists are unchanged, so the top value is
    bit-identical to the full-tree evaluation.  Raises
    :class:`LogicError` when a gate reads a slot of its own or a later
    level.
    """
    if tree.top_index is None:
        raise LogicError("prune_to_top_cone needs an anchored top event")
    base = tree.n_basic + tree.n_house

    # Reverse reachability from the top, one vectorized pass over the
    # levels in reverse topological order.  A single sweep reaches the
    # whole cone only if every gate reads strictly lower levels, so that
    # is checked, not assumed: a same-level or forward argument would
    # silently drop part of the cone.
    level_of = np.full(tree.n_nodes, -1, dtype=np.int64)
    for li, level in enumerate(tree.levels):
        for _kind, b in level.iter_blocks():
            level_of[np.asarray(b.out_idx)] = li
    in_cone = np.zeros(tree.n_nodes, dtype=bool)
    in_cone[tree.top_index] = True
    for li in range(len(tree.levels) - 1, -1, -1):
        for _kind, b in tree.levels[li].iter_blocks():
            keep = in_cone[np.asarray(b.out_idx)]
            if not keep.any():
                continue
            args = np.asarray(b.arg_idx)[keep]
            mask = getattr(b, "arg_mask", None)
            if mask is not None:
                args = args[np.asarray(mask)[keep]]
            args = args.reshape(-1)
            if (level_of[args] >= li).any():
                bad = int(args[np.argmax(level_of[args] >= li)])
                raise LogicError(
                    f"tree is not strictly levelled: a level-{li} gate "
                    f"reads slot {bad} of level {int(level_of[bad])}")
            in_cone[args] = True
    n_cone = int(in_cone[base:].sum())
    if n_cone == tree.n_gates:
        return tree

    # New slots in traversal order (keeps blocks' outputs contiguous),
    # as a dense old-slot -> new-slot lookup table (identity below
    # ``base``, so remaps are single numpy gathers).
    lut = np.arange(tree.n_nodes, dtype=np.int64)
    next_slot = base
    for level in tree.levels:
        for _kind, b in level.iter_blocks():
            out = np.asarray(b.out_idx)
            kept = out[in_cone[out]]
            lut[kept] = np.arange(next_slot, next_slot + len(kept))
            next_slot += len(kept)
    gate_slots = np.nonzero(in_cone)[0]
    new_slot = {int(s): int(lut[s])       # gates/gate_index remap
                for s in gate_slots[gate_slots >= base]}

    def remap(idx: np.ndarray) -> np.ndarray:
        return lut[idx].astype(idx.dtype)

    new_levels = []
    for level in tree.levels:
        prods, pairs, counts = [], [], []
        for kind, b in level.iter_blocks():
            keep = in_cone[np.asarray(b.out_idx)]
            if not keep.any():
                continue
            out_idx = lut[np.asarray(b.out_idx)[keep]].astype(np.int32)
            if kind == "prod":
                prods.append(ProdBlock(
                    out_idx, remap(b.arg_idx[keep]), b.arg_flip[keep],
                    b.arg_mask[keep], b.inv_out[keep]))
            elif kind == "pair":
                pairs.append(PairBlock(
                    out_idx, remap(b.arg_idx[keep]), b.arg_neg[keep],
                    b.is_iff[keep]))
            else:
                counts.append(CountBlock(
                    out_idx, remap(b.arg_idx[keep]), b.arg_neg[keep],
                    b.arg_mask[keep], b.min_num[keep], b.max_num[keep],
                    b.cap))
        if prods or pairs or counts:
            new_levels.append(LevelBlock(prods, pairs, counts))

    slot_to_gate = {tree.gate_index[g.id]: g for g in tree.gates}
    new_gates = [slot_to_gate[s]
                 for s in sorted(new_slot, key=new_slot.__getitem__)
                 if s in slot_to_gate]
    new_gate_index = {gid: new_slot[s]
                      for gid, s in tree.gate_index.items()
                      if s in new_slot}
    return CompiledTree(
        n_basic=tree.n_basic, n_house=tree.n_house, n_gates=n_cone,
        basic_index=tree.basic_index, house_index=tree.house_index,
        gate_index=new_gate_index, levels=new_levels,
        basic_events=tree.basic_events, house_events=tree.house_events,
        gates=new_gates, top_index=new_slot[tree.top_index])
