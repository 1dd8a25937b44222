"""Module detection and modular BDD quantification.

A *module* is a gate whose descendants are reachable only through it
(Dutuit & Rauzy's linear-time visit-date criterion). Modules are
statistically independent of the rest of the tree, so exact analysis
decomposes: build a BDD per module (over its own few inputs), collapse
the module to a pseudo basic event carrying its computed probability, and
quantify the reduced tree — the same exact answer with BDDs that stay
small where one monolithic BDD would blow up. This is the standard
preprocessor step of the reference lineage (SCRAM's PDAG preprocessing)
realized array-side:

* detection runs on the compiled slot graph (one DFS, visit dates,
  bottom-up min/max combine);
* each module compiles to a :class:`~canopy_tpu.compiler.bdd.CompiledBdd`
  whose variables point at *global* value-vector slots; evaluation fuses
  every module's Shannon nodes into one level schedule over one value
  matrix (:class:`~canopy_tpu.compiler.bdd.FusedChain`) — module outputs
  become inputs of enclosing modules with no host round-trips, and the
  whole chain stays `jit`/`vmap`/`grad` compatible.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..errors import LogicError
from ..mef.event import BasicEvent, Gate, HouseEvent
from .bdd import (BddForest, CompiledBdd, FusedChain, NativeBddForest,
                  _schedule, fuse_chain, fused_probability)
from .graph import CompiledTree, _emit_gate_ops

__all__ = ["find_modules", "build_modular_bdd", "modular_probability",
           "ModularBdd"]


def _gate_args(tree: CompiledTree, gate: Gate):
    """(slot, complement) argument pairs with CCF indirection applied."""
    out = []
    for arg in gate.formula.args:
        event = arg.event
        if isinstance(event, BasicEvent) and event.has_ccf \
                and event.ccf_gate.id in tree.gate_index:
            slot = tree.gate_index[event.ccf_gate.id]
        elif isinstance(event, Gate):
            slot = tree.gate_index[event.id]
        elif isinstance(event, BasicEvent):
            slot = tree.basic_index[event.id]
        else:
            slot = tree.house_index.get(event.id)
            if slot is None:
                slot = -1 if event.state else -2  # TRUE/FALSE singletons.
        out.append((slot, arg.complement))
    return out


def find_modules(tree: CompiledTree) -> list[int]:
    """Slots of module gates (visit-date criterion), excluding the top.

    A gate g is a module iff every visit date of every proper descendant
    falls strictly inside [first_entry(g), last_exit(g)].
    """
    if tree.top_index is None:
        raise LogicError("Compiled tree has no top gate.")
    n_basic_house = tree.n_basic + tree.n_house
    gate_of_slot = {tree.gate_index[g.id]: g for g in tree.gates}

    args_of: dict[int, list[int]] = {}
    if gate_of_slot:
        for slot, gate in gate_of_slot.items():
            args_of[slot] = [s for s, _c in _gate_args(tree, gate)
                             if s >= 0]
    else:
        # Array-backed tree (no MEF gate objects): argument structure
        # straight from the level-block rows.
        for _kind, out, args, _aux in _emit_gate_ops(tree):
            args_of[out] = [s for s, _f in args]

    clock = 0
    first: dict[int, int] = {}
    last: dict[int, int] = {}
    entry: dict[int, int] = {}
    exit_: dict[int, int] = {}
    visited: set[int] = set()
    # Iterative DFS from the top; children expanded on first visit only.
    stack: list[tuple[int, bool]] = [(tree.top_index, False)]
    while stack:
        slot, done = stack.pop()
        if done:
            clock += 1
            exit_[slot] = clock
            last[slot] = clock
            continue
        clock += 1
        if slot not in first:
            first[slot] = clock
        last[slot] = clock
        if slot in visited or slot < n_basic_house:
            continue
        visited.add(slot)
        entry[slot] = clock
        stack.append((slot, True))
        for arg in reversed(args_of.get(slot, [])):
            stack.append((arg, False))

    # Bottom-up min/max of descendant visit dates (slot order is
    # topological: args have smaller slots than their gates).
    INF = 1 << 60
    mn: dict[int, int] = {}
    mx: dict[int, int] = {}
    for slot in sorted(visited):
        lo, hi = INF, -INF
        for arg in args_of[slot]:
            lo = min(lo, first.get(arg, INF))
            hi = max(hi, last.get(arg, -INF))
            if arg in visited:  # Gate: include its subtree dates.
                lo = min(lo, mn[arg])
                hi = max(hi, mx[arg])
        mn[slot], mx[slot] = lo, hi

    modules = [slot for slot in visited
               if slot != tree.top_index
               and mn[slot] > entry[slot] and mx[slot] < exit_[slot]]
    return sorted(modules)


@dataclasses.dataclass
class ModularBdd:
    """Bottom-up chain of per-module BDDs over global slots."""

    #: (compiled bdd, output slot) pairs; the last one is the top.
    chain: list[tuple[CompiledBdd, int]]
    n_nodes: int
    n_basic: int
    top_index: int
    _fused: FusedChain | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def total_nodes(self) -> int:
        return sum(bdd.n_nodes for bdd, _ in self.chain)

    @property
    def largest(self) -> int:
        return max((bdd.n_nodes for bdd, _ in self.chain), default=0)

    def fused(self) -> FusedChain:
        """The chain's :class:`FusedChain` (built once, then cached)."""
        if self._fused is None:
            self._fused = fuse_chain(self.chain, self.n_basic,
                                     self.top_index)
        return self._fused


def build_modular_bdd(tree: CompiledTree, max_nodes: int = 2_000_000,
                      house_states=None,
                      use_native: bool | None = None) -> ModularBdd:
    """Per-module BDDs, innermost first, top last."""
    if use_native is None:
        from ..native import native_available
        use_native = native_available()
    modules = set(find_modules(tree))
    if house_states is None:
        house_states = tree.house_state_vector()
    house_of_slot = {tree.n_basic + i: bool(house_states[i] > 0.5)
                     for i in range(tree.n_house)}
    gate_of_slot = {tree.gate_index[g.id]: g for g in tree.gates}
    rows_of_slot: dict[int, tuple] = {}
    if not gate_of_slot:
        # Array-backed tree: gate semantics from the level-block rows
        # (the same rows every engine evaluates).
        for kind, out, args, aux in _emit_gate_ops(tree):
            rows_of_slot[out] = (kind, args, aux)

    # Bottom-up order: slot order is topological by construction.
    roots = sorted(modules) + [tree.top_index]
    chain: list[tuple[CompiledBdd, int]] = []
    for root_slot in roots:
        forest = (NativeBddForest(tree.n_nodes, max_nodes=max_nodes)
                  if use_native else
                  BddForest(tree.n_nodes, max_nodes=max_nodes))
        var_of_slot: dict[int, int] = {}
        memo: dict[int, int] = {}

        def var_for(slot: int) -> int:
            var = var_of_slot.get(slot)
            if var is None:
                var = len(var_of_slot)
                var_of_slot[slot] = var
            return forest.var_node(var)

        def node_for(slot: int) -> int:
            # Terminal-ish inputs: basics, house, collapsed modules.
            if slot == -1:
                return 1
            if slot == -2:
                return 0
            if slot < tree.n_basic:
                return var_for(slot)
            if slot in house_of_slot:
                return 1 if house_of_slot[slot] else 0
            if slot in modules and slot != root_slot:
                return var_for(slot)  # Collapsed inner module.
            found = memo.get(slot)
            if found is not None:
                return found
            result = (_gate_bdd(gate_of_slot[slot]) if gate_of_slot
                      else _row_bdd(rows_of_slot[slot]))
            memo[slot] = result
            return result

        def _row_bdd(row) -> int:
            kind, args, aux = row
            nodes = []
            for slot, flag in args:
                n = node_for(slot)
                nodes.append(forest.not_(n) if flag else n)
            if kind == "prod":
                out = 1
                for a in nodes:
                    out = forest.and_(out, a)
                return forest.not_(out) if aux else out
            if kind == "pair":
                x = forest.xor(nodes[0], nodes[1])
                return forest.not_(x) if aux else x
            lo, hi = aux
            at_lo = forest.atleast(lo, nodes) if lo > 0 else 1
            above = forest.atleast(hi + 1, nodes) \
                if hi < len(nodes) else 0
            return forest.and_(at_lo, forest.not_(above))

        def _gate_bdd(gate: Gate) -> int:
            from ..mef.event import Connective
            c = gate.formula.connective
            arg_nodes = []
            for slot, complement in _gate_args(tree, gate):
                node = node_for(slot)
                arg_nodes.append(forest.not_(node) if complement else node)
            if c is Connective.AND:
                out = 1
                for a in arg_nodes:
                    out = forest.and_(out, a)
                return out
            if c is Connective.OR:
                out = 0
                for a in arg_nodes:
                    out = forest.or_(out, a)
                return out
            if c is Connective.NAND:
                out = 1
                for a in arg_nodes:
                    out = forest.and_(out, a)
                return forest.not_(out)
            if c is Connective.NOR:
                out = 0
                for a in arg_nodes:
                    out = forest.or_(out, a)
                return forest.not_(out)
            if c in (Connective.NOT,):
                return forest.not_(arg_nodes[0])
            if c is Connective.NULL:
                return arg_nodes[0]
            if c is Connective.XOR:
                return forest.xor(arg_nodes[0], arg_nodes[1])
            if c is Connective.IFF:
                return forest.not_(forest.xor(arg_nodes[0], arg_nodes[1]))
            if c is Connective.IMPLY:
                return forest.or_(forest.not_(arg_nodes[0]), arg_nodes[1])
            if c is Connective.ATLEAST:
                return forest.atleast(gate.formula.min_number, arg_nodes)
            if c is Connective.CARDINALITY:
                lo, hi = gate.formula.min_number, gate.formula.max_number
                at_lo = forest.atleast(lo, arg_nodes) if lo > 0 else 1
                above = forest.atleast(hi + 1, arg_nodes) \
                    if hi < len(arg_nodes) else 0
                return forest.and_(at_lo, forest.not_(above))
            raise LogicError(f"Unsupported connective {c}")

        root = node_for(root_slot)
        forest.check_overflow()
        slot_of_var = {v: s for s, v in var_of_slot.items()}
        chain.append((_schedule(forest, root, tree.n_basic, slot_of_var),
                      root_slot))
    return ModularBdd(chain=chain, n_nodes=tree.n_nodes,
                      n_basic=tree.n_basic, top_index=tree.top_index)


def modular_probability(modular: ModularBdd,
                        basic_p: jnp.ndarray) -> jnp.ndarray:
    """Exact top probability via the module chain.

    ``basic_p``: (..., n_basic). Every module's BDD evaluates in one
    fused level schedule (:class:`~canopy_tpu.compiler.bdd.FusedChain`):
    a module's output feeds the nodes of enclosing modules that decide on
    it.
    """
    return fused_probability(modular.fused(), basic_p)
