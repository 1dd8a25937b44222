"""Binary decision diagrams: the exact quantification structure.

The reference names BDD as its default qualitative/quantitative algorithm
(``settings.h:13``, ``Algorithm::kBdd``). Direct bottom-up probability
propagation is exact only for tree-like structures; any shared basic event
(CCF expansions guarantee them) needs Shannon decomposition. The
split mirrors the reference's host/device split for ``src/bool/bool``:

* **Host (this module)**: reduce the gate DAG to an ROBDD with an
  ite-based apply, a unique table, and an operation memo — classic
  CUDD-style construction (no complement edges; NOT is one memoized
  traversal). Variable order = DFS first-touch order of basic events, a
  standard structural heuristic.
* **Device** (:func:`fused_probability`): probability evaluation of the
  ROBDD is a *linear* pass — ``P(node) = p_var * P(high) + (1-p_var) *
  P(low)`` — which this module level-schedules (longest path from the
  terminals) so each level is one batched gather+FMA on device: the same
  static-shape, data-parallel form as the gate propagation, but exact.
  Batched over a trials axis it is the exact-uncertainty SpMM; under
  `jax.grad` it yields exact Birnbaum importances.  One monolithic BDD
  and a chain of module BDDs (``compiler/modules.py``) run through the
  same :class:`FusedChain` program.

Construction cost is exponential in the worst case (it is for every BDD
engine); `max_nodes` guards against blowup so callers can fall back to
cut-set approximations.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import LogicError
from ..mef.event import BasicEvent, Connective, Formula, Gate, HouseEvent
from .graph import CompiledTree, _emit_gate_ops

__all__ = ["BddForest", "CompiledBdd", "FusedChain", "build_bdd",
           "build_bdd_multi", "fuse_chain", "fused_probability"]

_ZERO = 0  # Terminal node indices.
_ONE = 1


class BddBlowupError(LogicError):
    """BDD construction exceeded the node budget."""


class BddForest:
    """ROBDD manager: unique table + ite/apply memoization."""

    def __init__(self, n_vars: int, max_nodes: int = 2_000_000):
        self.n_vars = n_vars
        self.max_nodes = max_nodes
        # Node storage; index 0/1 are terminals (var = n_vars sentinel).
        self.var = [n_vars, n_vars]
        self.low = [0, 1]
        self.high = [0, 1]
        self._unique: dict[tuple[int, int, int], int] = {}
        self._ite_memo: dict[tuple[int, int, int], int] = {}
        self._not_memo: dict[int, int] = {}

    @property
    def n_nodes(self) -> int:
        return len(self.var)

    def mk(self, var: int, low: int, high: int) -> int:
        if low == high:
            return low
        key = (var, low, high)
        found = self._unique.get(key)
        if found is not None:
            return found
        if self.n_nodes >= self.max_nodes:
            raise BddBlowupError(
                f"BDD exceeded {self.max_nodes} nodes; use an approximate "
                "engine for this model.")
        index = self.n_nodes
        self.var.append(var)
        self.low.append(low)
        self.high.append(high)
        self._unique[key] = index
        return index

    def var_node(self, var: int) -> int:
        return self.mk(var, _ZERO, _ONE)

    # -- core operations ---------------------------------------------------

    def ite(self, f: int, g: int, h: int) -> int:
        """if-then-else composition: f ? g : h (iterative, stack-based)."""
        # Terminal shortcuts.
        if f == _ONE:
            return g
        if f == _ZERO:
            return h
        if g == h:
            return g
        if g == _ONE and h == _ZERO:
            return f
        key = (f, g, h)
        found = self._ite_memo.get(key)
        if found is not None:
            return found
        top = min(self.var[f], self.var[g], self.var[h])

        def cofactor(node: int, value: bool) -> int:
            if self.var[node] != top:
                return node
            return self.high[node] if value else self.low[node]

        high = self.ite(cofactor(f, True), cofactor(g, True),
                        cofactor(h, True))
        low = self.ite(cofactor(f, False), cofactor(g, False),
                       cofactor(h, False))
        result = self.mk(top, low, high)
        self._ite_memo[key] = result
        return result

    def and_(self, f: int, g: int) -> int:
        return self.ite(f, g, _ZERO)

    def or_(self, f: int, g: int) -> int:
        return self.ite(f, _ONE, g)

    def not_(self, f: int) -> int:
        found = self._not_memo.get(f)
        if found is not None:
            return found
        if f in (_ZERO, _ONE):
            return _ONE - f
        result = self.mk(self.var[f], self.not_(self.low[f]),
                         self.not_(self.high[f]))
        self._not_memo[f] = result
        return result

    def xor(self, f: int, g: int) -> int:
        return self.ite(f, self.not_(g), g)

    def atleast(self, k: int, args: list[int]) -> int:
        """K-out-of-N over BDD arguments (memoized double recursion)."""
        memo: dict[tuple[int, int], int] = {}

        def rec(need: int, index: int) -> int:
            if need <= 0:
                return _ONE
            if len(args) - index < need:
                return _ZERO
            key = (need, index)
            found = memo.get(key)
            if found is not None:
                return found
            with_arg = rec(need - 1, index + 1)
            without_arg = rec(need, index + 1)
            result = self.ite(args[index], with_arg, without_arg)
            memo[key] = result
            return result

        return rec(k, 0)

    def snapshot(self):
        """(var, low, high) node arrays for scheduling."""
        return (np.asarray(self.var, dtype=np.int32),
                np.asarray(self.low, dtype=np.int32),
                np.asarray(self.high, dtype=np.int32))

    def check_overflow(self) -> None:
        pass  # mk() raises eagerly.


class NativeBddForest:
    """ctypes facade over the C++ forest (same surface as BddForest).

    ~20-50x faster construction than the Python forest on large models;
    selected automatically by :func:`build_bdd` when the native library
    builds (``canopy_tpu/native/bdd.cpp``).
    """

    def __init__(self, n_vars: int, max_nodes: int = 2_000_000):
        from ..native import load_bdd_library

        self._lib = load_bdd_library()
        assert self._lib is not None
        self.n_vars = n_vars
        self.max_nodes = max_nodes
        self._forest = self._lib.canopy_bdd_new(n_vars, max_nodes)

    def __del__(self):  # pragma: no cover - finalization
        lib = getattr(self, "_lib", None)
        forest = getattr(self, "_forest", None)
        if lib is not None and forest:
            lib.canopy_bdd_free(forest)

    @property
    def n_nodes(self) -> int:
        return int(self._lib.canopy_bdd_n_nodes(self._forest))

    def var_node(self, var: int) -> int:
        return self._lib.canopy_bdd_var(self._forest, var)

    def ite(self, f: int, g: int, h: int) -> int:
        return self._lib.canopy_bdd_ite(self._forest, f, g, h)

    def and_(self, f: int, g: int) -> int:
        return getattr(self._lib, "canopy_bdd_and")(self._forest, f, g)

    def or_(self, f: int, g: int) -> int:
        return getattr(self._lib, "canopy_bdd_or")(self._forest, f, g)

    def not_(self, f: int) -> int:
        return getattr(self._lib, "canopy_bdd_not")(self._forest, f)

    def xor(self, f: int, g: int) -> int:
        return self._lib.canopy_bdd_xor(self._forest, f, g)

    def atleast(self, k: int, args: list[int]) -> int:
        import ctypes

        arr = (ctypes.c_int32 * len(args))(*args)
        return self._lib.canopy_bdd_atleast(self._forest, k, arr, len(args))

    def snapshot(self):
        import ctypes

        n = self.n_nodes
        var = np.empty(n, dtype=np.int32)
        low = np.empty(n, dtype=np.int32)
        high = np.empty(n, dtype=np.int32)
        self._lib.canopy_bdd_export(
            self._forest,
            var.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            low.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            high.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return var, low, high

    def check_overflow(self) -> None:
        if self._lib.canopy_bdd_overflow(self._forest):
            raise BddBlowupError(
                f"BDD exceeded {self.max_nodes} nodes; use an approximate "
                "engine for this model.")


@dataclasses.dataclass
class CompiledBdd:
    """An ROBDD root with level-scheduled arrays for device evaluation."""

    root: int
    complemented: bool           # True when the root is NOT(stored root).
    n_basic: int
    n_nodes: int                 # Internal (non-terminal) nodes.
    # Per level: (var_slot, low_ptr, high_ptr) arrays. Pointers address a
    # value vector laid out [zero, one, node0, node1, ...].
    levels: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    # (out_ptr per level included as 4th array)
    root_ptr: int
    # Raw forest node arrays (terminals at 0/1) for qualitative passes
    # (ZBDD minimal cut sets); None for trivially-constant roots.
    raw_var: np.ndarray | None = None
    raw_low: np.ndarray | None = None
    raw_high: np.ndarray | None = None
    slot_of_var: dict[int, int] | None = None
    _fused: FusedChain | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def depth(self) -> int:
        return len(self.levels)

    def fused(self) -> FusedChain:
        """This BDD as a one-module :class:`FusedChain` (built once)."""
        if self._fused is None:
            self._fused = fuse_chain([(self, self.n_basic)], self.n_basic,
                                     self.n_basic)
        return self._fused

    def resolved_root(self) -> int:
        """The raw-array root index; 0/1 for trivially-constant BDDs
        (whose node arrays are empty, so ``root`` is meaningless)."""
        if self.n_nodes:
            return int(self.root)
        return 1 if self.root_ptr == 1 else 0


def build_bdd(tree: CompiledTree, max_nodes: int = 2_000_000,
              house_states=None, use_native: bool | None = None
              ) -> CompiledBdd:
    """Reduce a compiled gate DAG to an ROBDD and level-schedule it.

    House events fold to constants: ``house_states`` (0/1 array over the
    tree's house slots) overrides their current model states. Rebuild to
    change them — unlike the propagation engine, the Shannon structure
    depends on house values.
    """
    if tree.top_index is None:
        raise LogicError("The compiled tree has no top gate.")
    return build_bdd_multi(tree, [tree.top_index], max_nodes=max_nodes,
                           house_states=house_states,
                           use_native=use_native)[0]


def build_bdd_multi(tree: CompiledTree, root_slots: list[int],
                    max_nodes: int = 2_000_000, house_states=None,
                    use_native: bool | None = None) -> list[CompiledBdd]:
    """One forest pass, many roots.

    Event-tree sequence quantification anchors dozens of roots on one
    shared compiled DAG (``engine/analysis._analyze_event_tree``); the
    ITE memo tables are shared across all of them, so the forest builds
    once and each root only pays its own level scheduling — instead of
    re-deriving the whole forest per sequence.
    """

    # Variable order: first-touch DFS order over the compiled structure.
    order: dict[int, int] = {}

    def touch(slot: int):
        if slot < tree.n_basic and slot not in order:
            order[slot] = len(order)

    for level in tree.levels:
        for _kind, block in level.iter_blocks():
            for row in np.asarray(block.arg_idx).reshape(-1):
                touch(int(row))
    for slot in range(tree.n_basic):
        touch(slot)
    var_of_slot = order
    slot_of_var = {v: s for s, v in var_of_slot.items()}

    if use_native is None:
        from ..native import native_available
        use_native = native_available()
    forest = (NativeBddForest(tree.n_basic, max_nodes=max_nodes)
              if use_native else
              BddForest(tree.n_basic, max_nodes=max_nodes))
    if house_states is None:
        house_state = {tree.n_basic + i: bool(h.state)
                       for i, h in enumerate(tree.house_events)}
    else:
        house_state = {tree.n_basic + i: bool(house_states[i] > 0.5)
                       for i in range(tree.n_house)}

    node_bdd: dict[int, int] = {}
    for slot in range(tree.n_basic):
        node_bdd[slot] = forest.var_node(var_of_slot[slot])
    for slot, state in house_state.items():
        node_bdd[slot] = _ONE if state else _ZERO

    # Gates in slot order are already level-ordered (args first).
    if tree.gates:
        for gate in tree.gates:
            slot = tree.gate_index[gate.id]
            node_bdd[slot] = _formula_bdd(forest, gate.formula, tree,
                                          node_bdd)
    else:
        # Array-backed tree (no MEF gate objects — e.g. synthetic or
        # deserialized compiled models): build gate BDDs straight from
        # the level-block rows, whose semantics are the ones every
        # engine evaluates (maybe-NOT of AND over maybe-NOT'ed args /
        # XOR-IFF pairs / count windows).
        for kind, out, args, aux in _emit_gate_ops(tree):
            nodes = []
            for slot, flag in args:
                b = node_bdd[slot]
                nodes.append(forest.not_(b) if flag else b)
            if kind == "prod":
                acc = _ONE
                for b in nodes:
                    acc = forest.and_(acc, b)
                node_bdd[out] = forest.not_(acc) if aux else acc
            elif kind == "pair":
                x = forest.xor(nodes[0], nodes[1])
                node_bdd[out] = forest.not_(x) if aux else x
            else:  # count: [lo, hi] successes window
                lo, hi = aux
                at_lo = forest.atleast(lo, nodes) if lo > 0 else _ONE
                above = forest.atleast(hi + 1, nodes) \
                    if hi < len(nodes) else _ZERO
                node_bdd[out] = forest.and_(at_lo, forest.not_(above))
    forest.check_overflow()

    return [_schedule(forest, node_bdd[slot], tree.n_basic, slot_of_var)
            for slot in root_slots]


def _arg_bdd(forest: BddForest, arg, tree: CompiledTree,
             node_bdd: dict[int, int]) -> int:
    event = arg.event
    # The CCF proxy applies only when the tree was compiled with CCF
    # expansion (ccf_analysis off keeps the original basic events).
    if isinstance(event, BasicEvent) and event.has_ccf \
            and event.ccf_gate.id in tree.gate_index:
        slot = tree.gate_index[event.ccf_gate.id]
    elif isinstance(event, Gate):
        slot = tree.gate_index[event.id]
    elif isinstance(event, BasicEvent):
        slot = tree.basic_index[event.id]
    else:
        assert isinstance(event, HouseEvent)
        slot = tree.house_index.get(event.id)
        if slot is None:  # TRUE/FALSE singletons not in the index.
            return _ONE if event.state else _ZERO
    f = node_bdd[slot]
    return forest.not_(f) if arg.complement else f


def _formula_bdd(forest: BddForest, formula: Formula, tree: CompiledTree,
                 node_bdd: dict[int, int]) -> int:
    c = formula.connective
    args = [_arg_bdd(forest, arg, tree, node_bdd) for arg in formula.args]
    if c is Connective.AND:
        out = _ONE
        for a in args:
            out = forest.and_(out, a)
        return out
    if c is Connective.OR:
        out = _ZERO
        for a in args:
            out = forest.or_(out, a)
        return out
    if c is Connective.NAND:
        out = _ONE
        for a in args:
            out = forest.and_(out, a)
        return forest.not_(out)
    if c is Connective.NOR:
        out = _ZERO
        for a in args:
            out = forest.or_(out, a)
        return forest.not_(out)
    if c is Connective.NOT:
        return forest.not_(args[0])
    if c is Connective.NULL:
        return args[0]
    if c is Connective.XOR:
        return forest.xor(args[0], args[1])
    if c is Connective.IFF:
        return forest.not_(forest.xor(args[0], args[1]))
    if c is Connective.IMPLY:
        return forest.or_(forest.not_(args[0]), args[1])
    if c is Connective.ATLEAST:
        return forest.atleast(formula.min_number, args)
    if c is Connective.CARDINALITY:
        lo, hi = formula.min_number, formula.max_number
        at_lo = forest.atleast(lo, args) if lo > 0 else _ONE
        above = forest.atleast(hi + 1, args) if hi < len(args) else _ZERO
        return forest.and_(at_lo, forest.not_(above))
    raise LogicError(f"Unsupported connective for BDD: {c}")


def _schedule(forest, root: int, n_basic: int,
              slot_of_var: dict[int, int]) -> CompiledBdd:
    """Collect reachable nodes and group them into dependency levels."""
    var_arr, low_arr, high_arr = forest.snapshot()
    if root in (_ZERO, _ONE):
        return CompiledBdd(root=root, complemented=False, n_basic=n_basic,
                           n_nodes=0, levels=[], root_ptr=root,
                           raw_var=var_arr, raw_low=low_arr,
                           raw_high=high_arr, slot_of_var=dict(slot_of_var))

    # Post-order (children before parents) over the reachable set.
    depth: dict[int, int] = {_ZERO: 0, _ONE: 0}
    order_stack: list[tuple[int, bool]] = [(root, False)]
    post: list[int] = []
    visited: set[int] = set()
    while order_stack:
        node, expanded = order_stack.pop()
        if node in (_ZERO, _ONE):
            continue
        if expanded:
            post.append(node)
            continue
        if node in visited:
            continue
        visited.add(node)
        order_stack.append((node, True))
        order_stack.append((int(low_arr[node]), False))
        order_stack.append((int(high_arr[node]), False))
    for node in post:
        depth[node] = 1 + max(depth[int(low_arr[node])],
                              depth[int(high_arr[node])])

    n_levels = max(depth[n] for n in post)
    by_level: list[list[int]] = [[] for _ in range(n_levels)]
    for node in post:
        by_level[depth[node] - 1].append(node)

    # Value-vector pointers: [0]=zero, [1]=one, then internal nodes in
    # level order.
    ptr: dict[int, int] = {_ZERO: 0, _ONE: 1}
    next_ptr = 2
    for level_nodes in by_level:
        for node in level_nodes:
            ptr[node] = next_ptr
            next_ptr += 1

    levels = []
    for level_nodes in by_level:
        var_slot = np.array([slot_of_var[int(var_arr[n])]
                             for n in level_nodes], dtype=np.int32)
        low_ptr = np.array([ptr[int(low_arr[n])] for n in level_nodes],
                           dtype=np.int32)
        high_ptr = np.array([ptr[int(high_arr[n])] for n in level_nodes],
                            dtype=np.int32)
        out_ptr = np.array([ptr[n] for n in level_nodes], dtype=np.int32)
        levels.append((var_slot, low_ptr, high_ptr, out_ptr))

    return CompiledBdd(root=root, complemented=False, n_basic=n_basic,
                       n_nodes=len(post), levels=levels,
                       root_ptr=ptr[root], raw_var=var_arr,
                       raw_low=low_arr, raw_high=high_arr,
                       slot_of_var=dict(slot_of_var))


@dataclasses.dataclass
class FusedChain:
    """A chain of BDDs as one level-scheduled Shannon program.

    The chain lists ``(bdd, output slot)`` pairs, innermost first: a BDD
    may decide on the output slot of an earlier one (a collapsed module,
    ``compiler/modules.py``); a single BDD is a one-link chain.  Value
    rows are ``[zero, one, basics..., nodes...]``.  A node's level is one
    more than the deepest of its two children and of its decision
    variable, where an earlier BDD's output sits at that BDD's root.
    BDDs at the same depth therefore evaluate in the same level, and a
    chain of thousands of small modules takes as many batched steps as
    its deepest path instead of one step per node level of every module.
    Per level: ``(rows, out_start)``, where ``rows`` concatenates the
    decision-variable, low-child and high-child rows of the level's
    nodes, whose outputs fill consecutive rows from ``out_start``.

    ``segments`` is what the device runs: runs of consecutive levels
    padded to one power-of-two width each, ``(rows (L, 3W), out (L, W))``,
    whose padding reads and writes the scratch row ``n_rows``.  Each
    segment is one ``lax.scan``, so compile time grows with the number of
    segments, not levels; a level is at most 4x narrower than its
    segment's width.
    """

    n_rows: int
    n_basic: int
    levels: list[tuple[np.ndarray, int]]
    top_row: int
    segments: list[tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=list)


def fuse_chain(chain: list[tuple[CompiledBdd, int]], n_basic: int,
               top_slot: int) -> FusedChain:
    """Fuse ``chain`` into one :class:`FusedChain` whose top is the BDD
    written to ``top_slot``.  Vectorized per BDD level."""
    base = 2 + n_basic
    n_slots = 1 + max([n_basic] + [out for _bdd, out in chain])
    slot_depth = np.zeros(n_slots, np.int64)   # Basics: depth 0.
    empty = np.zeros(0, np.int64)
    depths, modules, ptrs, vars_, lows, highs = [], [], [], [], [], []
    for m, (bdd, out_slot) in enumerate(chain):
        depth = np.zeros(bdd.n_nodes + 2, np.int64)  # Terminals: depth 0.
        for var, lo, hi, out in bdd.levels:
            depth[out] = 1 + np.maximum(slot_depth[var],
                                        np.maximum(depth[lo], depth[hi]))
        slot_depth[out_slot] = depth[bdd.root_ptr]
        cols = list(zip(*bdd.levels)) or [[empty]] * 4
        var, lo, hi, out = (np.concatenate(c).astype(np.int64)
                            for c in cols)
        depths.append(depth[out])
        modules.append(np.full(len(out), m, np.int64))
        ptrs.append(out)
        vars_.append(var)
        lows.append(lo)
        highs.append(hi)

    # Rows in (depth, module, local pointer) order.
    d_all = np.concatenate(depths + [empty])
    order = np.lexsort((np.concatenate(ptrs + [empty]),
                        np.concatenate(modules + [empty]), d_all))
    row_all = np.empty(len(order), np.int64)
    row_all[order] = base + np.arange(len(order))
    slot_row = np.zeros(n_slots, np.int64)
    slot_row[:n_basic] = 2 + np.arange(n_basic)
    rowmaps = []
    offset = 0
    for (bdd, out_slot), out in zip(chain, ptrs):
        rowmap = np.arange(bdd.n_nodes + 2, dtype=np.int64)  # 0, 1 stay.
        rowmap[out] = row_all[offset:offset + len(out)]
        offset += len(out)
        slot_row[out_slot] = rowmap[bdd.root_ptr]
        rowmaps.append(rowmap)
    var_row = slot_row[np.concatenate(vars_ + [empty])][order]
    low_row = np.concatenate([r[lo] for r, lo in zip(rowmaps, lows)]
                             + [empty])[order]
    high_row = np.concatenate([r[hi] for r, hi in zip(rowmaps, highs)]
                              + [empty])[order]

    d_sorted = d_all[order]
    bounds = np.flatnonzero(np.diff(d_sorted)) + 1
    levels = []
    for start, stop in zip(np.r_[0, bounds], np.r_[bounds, len(order)]):
        if stop > start:
            rows = np.concatenate([var_row[start:stop], low_row[start:stop],
                                   high_row[start:stop]]).astype(np.int32)
            levels.append((rows, base + int(start)))
    n_rows = base + len(order)
    return FusedChain(n_rows=n_rows, n_basic=n_basic, levels=levels,
                      top_row=int(slot_row[top_slot]),
                      segments=_segments(levels, n_rows))


def _segments(levels, scratch: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Group consecutive levels into padded ``lax.scan`` segments."""
    groups: list[list[tuple[np.ndarray, int]]] = []
    width = 0
    for level in levels:
        n = len(level[0]) // 3
        if not groups or n > width or 4 * n < width:
            groups.append([])
            width = 1 << max(n - 1, 0).bit_length()
        groups[-1].append(level)
    segments = []
    for group in groups:
        width = 1 << max(max(len(r) // 3 for r, _ in group) - 1,
                         0).bit_length()
        rows = np.full((len(group), 3, width), scratch, dtype=np.int32)
        out = np.full((len(group), width), scratch, dtype=np.int32)
        for i, (level_rows, out_start) in enumerate(group):
            n = len(level_rows) // 3
            rows[i, :, :n] = level_rows.reshape(3, n)
            out[i, :n] = np.arange(out_start, out_start + n)
        segments.append((rows.reshape(len(group), 3 * width), out))
    return segments


def fused_probability(fused: FusedChain,
                      basic_p: jnp.ndarray) -> jnp.ndarray:
    """Exact top probability of a :class:`FusedChain`.

    ``basic_p``: (..., n_basic); returns (...).  The value matrix is
    node-major (``(rows, trials)``), so every gather reads whole rows.
    """
    batch_shape = basic_p.shape[:-1]
    n_trials = math.prod(batch_shape)
    p_nm = jnp.reshape(basic_p, (n_trials, fused.n_basic)).T
    vals = jnp.concatenate([
        jnp.zeros((1, n_trials), basic_p.dtype),
        jnp.ones((1, n_trials), basic_p.dtype), p_nm,
        jnp.zeros((fused.n_rows - 1 - fused.n_basic, n_trials),
                  basic_p.dtype)], axis=0)       # Last row: scratch.

    def level(vals, step):
        # One gather per level: decision, low and high rows stacked.
        rows, out = step
        p, lo, hi = jnp.reshape(vals[rows], (3, -1, n_trials))
        return vals.at[out].set(p * hi + (1.0 - p) * lo), None

    for rows, out in fused.segments:
        vals, _ = jax.lax.scan(level, vals,
                               (jnp.asarray(rows), jnp.asarray(out)))
    return jnp.reshape(vals[fused.top_row], batch_shape)
