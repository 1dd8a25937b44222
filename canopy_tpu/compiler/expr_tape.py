"""Expression tape compiler: MEF expression DAG -> one batched JAX program.

Replaces the reference's recursive scalar interpreter (SURVEY.md §3.2-3.3)
with an accelerator-friendly design:

* The expression DAG is flattened into a **static SSA tape** (one slot per
  unique node, deduplicated by object identity). Shared parameters are
  therefore evaluated exactly once per trial — the reference's
  memoize/reset sampling protocol (``expression.h:98-117``) holds *by
  construction*, with no mutable state.
* Pure-constant subtrees (no deviates, no mission-time dependence) are
  folded on the host at build time; everything else becomes vectorized
  `jnp` ops over an optional trials axis.
* Each random deviate node draws its whole trials axis in one call with a
  counter-based key ``fold_in(base_key, slot)`` — deterministic under any
  device count, fixing the reference's shared serial ``std::mt19937``
  hazard (``random_deviate.h:20-24``).
* Mission time is a traced scalar input, so time-step sweeps (SIL) re-use
  one compiled program.

Two evaluators are derived from one tape: ``evaluate_mean(mission_time)``
-> ``(n_out,)`` means, and ``sample(key, n_trials, mission_time)`` ->
``(n_trials, n_out)`` epistemic samples (the SpMM batch input).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import LogicError
from ..mef.expression import Expression
from ..mef.parameter import MissionTime, Parameter
from ..mef.expr.conditional import Ite, Switch
from ..mef.expr.constant import ConstantExpression
from ..mef.expr.exponential import Exponential, Glm, PeriodicTest, Weibull
from ..mef.expr.extern import ExternExpression
from ..mef.expr.random_deviate import (BetaDeviate, GammaDeviate, Histogram,
                                       LognormalDeviate, NormalDeviate,
                                       RandomDeviate, UniformDeviate)
from ..mef.expr.test_event import TestFunctionalEvent, TestInitiatingEvent

__all__ = ["ExpressionTape"]

#: Deviate kinds evaluated as vectorized groups when their arguments are
#: constants (the usual basic-event form).
_LEAF_KINDS = ("uniform-deviate", "normal-deviate", "lognormal-deviate")


# ---------------------------------------------------------------------------
# Elementwise op registry: tape_op -> jnp implementation over arg arrays.
# ---------------------------------------------------------------------------

def _chain_sub(first, *rest):
    return first - sum(rest) if rest else first


def _chain_div(first, *rest):
    out = first
    for r in rest:
        out = out / r
    return out


_ELEMENTWISE: dict[str, Callable] = {
    "neg": lambda x: -x,
    "add": lambda *xs: sum(xs),
    "sub": _chain_sub,
    "mul": lambda *xs: math.prod(xs),
    "div": _chain_div,
    "abs": jnp.abs,
    "acos": jnp.arccos,
    "asin": jnp.arcsin,
    "atan": jnp.arctan,
    "cos": jnp.cos,
    "sin": jnp.sin,
    "tan": jnp.tan,
    "cosh": jnp.cosh,
    "sinh": jnp.sinh,
    "tanh": jnp.tanh,
    "exp": jnp.exp,
    "log": jnp.log,
    "log10": jnp.log10,
    "mod": lambda x, y: jnp.fmod(jnp.trunc(x), jnp.trunc(y)),
    "pow": jnp.power,
    "sqrt": jnp.sqrt,
    "ceil": jnp.ceil,
    "floor": jnp.floor,
    "min": lambda *xs: functools.reduce(jnp.minimum, xs),
    "max": lambda *xs: functools.reduce(jnp.maximum, xs),
    "mean": lambda *xs: sum(xs) / len(xs),
    "bnot": lambda x: jnp.where(x != 0, 0.0, 1.0),
    "band": lambda *xs: math.prod([(x != 0) for x in xs]).astype(jnp.float64),
    "bor": lambda *xs: 1.0 - math.prod([(x == 0) for x in xs]).astype(jnp.float64),
    "eq": lambda x, y: (x == y).astype(jnp.float64),
    "df": lambda x, y: (x != y).astype(jnp.float64),
    "lt": lambda x, y: (x < y).astype(jnp.float64),
    "gt": lambda x, y: (x > y).astype(jnp.float64),
    "leq": lambda x, y: (x <= y).astype(jnp.float64),
    "geq": lambda x, y: (x >= y).astype(jnp.float64),
    "exponential": lambda lam, t: -jnp.expm1(-lam * t),
    "glm": lambda gamma, lam, mu, t: (
        lam - (lam - gamma * (lam + mu)) * jnp.exp(-(lam + mu) * t))
        / (lam + mu),
    "weibull": lambda alpha, beta, t0, t: jnp.where(
        t > t0, -jnp.expm1(-(((jnp.maximum(t - t0, 0.0)) / alpha) ** beta)),
        0.0),
}


def _periodic_test_4(lam, tau, theta, time):
    delta = jnp.where(time <= theta, time,
                      jnp.mod(time - theta, tau))
    return -jnp.expm1(-lam * delta)


def _propagate_segment_jnp(op, lat, rep, lam, mu, dt):
    dt = jnp.maximum(dt, 0.0)
    e_l = jnp.exp(-lam * dt)
    e_m = jnp.exp(-mu * dt)
    denom = mu - lam
    safe = jnp.abs(denom) > 1e-12 * jnp.maximum(jnp.maximum(mu, lam), 1.0)
    general = op * e_l + mu * rep * (e_l - e_m) / jnp.where(safe, denom, 1.0)
    degenerate = op * e_l + mu * rep * dt * e_l
    op_new = jnp.where(safe, general, degenerate)
    rep_new = rep * e_m
    return op_new, rep_new


def _periodic_test_5(lam, mu, tau, theta, time):
    """Vectorized version of the 3-state Markov propagation (see
    ``mef/expr/exponential.py:_instant_test``), as a `lax.while_loop`
    over test instants."""

    def cond(state):
        _, _, t, next_test = state
        return jnp.any(next_test < time)

    def body(state):
        op, rep, t, next_test = state
        active = next_test < time
        dt = jnp.where(active, next_test - t, 0.0)
        op2, rep2 = _propagate_segment_jnp(op, 1.0 - op - rep, rep, lam, mu,
                                           dt)
        lat2 = 1.0 - op2 - rep2
        # Test: latent -> repair.
        rep3 = jnp.where(active, rep2 + lat2, rep2)
        t2 = jnp.where(active, next_test, t)
        return (op2, rep3, t2, jnp.where(active, next_test + tau, next_test))

    shape = jnp.broadcast_shapes(jnp.shape(lam), jnp.shape(mu),
                                 jnp.shape(tau), jnp.shape(theta),
                                 jnp.shape(time))
    op0 = jnp.ones(shape)
    rep0 = jnp.zeros(shape)
    t0 = jnp.zeros(shape)
    next0 = jnp.broadcast_to(theta, shape).astype(jnp.float64)
    op, rep, t, _ = jax.lax.while_loop(cond, body, (op0, rep0, t0, next0))
    op_f, rep_f = _propagate_segment_jnp(op, 1.0 - op - rep, rep, lam, mu,
                                         time - t)
    return 1.0 - op_f


class ExpressionTape:
    """A compiled, batched evaluator for a set of output expressions."""

    def __init__(self):
        self._ops: list[tuple] = []          # (kind, out_slot, arg_slots, aux)
        self._slot_of: dict[int, int] = {}   # id(expr) -> slot
        self._n_slots = 0
        self._out_slots: list[int] = []
        self.n_deviates = 0
        self._groups: list[tuple] | None = None

    # ==================================================================
    # Build.
    # ==================================================================

    @classmethod
    def build(cls, expressions: list[Expression]) -> "ExpressionTape":
        tape = cls()
        tape._out_slots = [tape._visit(e) for e in expressions]
        return tape

    @property
    def n_outputs(self) -> int:
        return len(self._out_slots)

    @staticmethod
    def _depends_on_time(expr: Expression) -> bool:
        stack = [expr]
        seen: set[int] = set()
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, MissionTime):
                return True
            stack.extend(node.args)
        return False

    def _emit(self, kind: str, arg_slots: list[int], aux=None) -> int:
        slot = self._n_slots
        self._n_slots += 1
        self._ops.append((kind, slot, arg_slots, aux))
        return slot

    def _visit(self, expr: Expression) -> int:
        key = id(expr)
        if key in self._slot_of:
            return self._slot_of[key]
        slot = self._build_node(expr)
        self._slot_of[key] = slot
        return slot

    def _build_node(self, expr: Expression) -> int:
        # Constant folding: pure deterministic subtrees evaluate on host.
        if not expr.is_deviate() and not self._depends_on_time(expr):
            return self._emit("const", [], float(expr.value()))

        if isinstance(expr, MissionTime):
            return self._emit("mission-time", [])
        if isinstance(expr, Parameter):
            return self._emit("alias", [self._visit(expr.expression)])
        if isinstance(expr, (TestInitiatingEvent, TestFunctionalEvent)):
            return self._emit("const", [], float(expr.value()))
        if isinstance(expr, ConstantExpression):
            return self._emit("const", [], float(expr.value()))
        if isinstance(expr, ExternExpression):
            raise LogicError(
                "extern-function expressions with stochastic or "
                "time-dependent arguments cannot be compiled to the "
                "device tape; make them deterministic or evaluate on the host.")

        arg_slots = [self._visit(a) for a in expr.args]

        if isinstance(expr, UniformDeviate):
            self.n_deviates += 1
            return self._emit("uniform-deviate", arg_slots)
        if isinstance(expr, NormalDeviate):
            self.n_deviates += 1
            return self._emit("normal-deviate", arg_slots)
        if isinstance(expr, LognormalDeviate):
            self.n_deviates += 1
            return self._emit("lognormal-deviate", arg_slots, expr.flavor)
        if isinstance(expr, GammaDeviate):
            self.n_deviates += 1
            return self._emit("gamma-deviate", arg_slots)
        if isinstance(expr, BetaDeviate):
            self.n_deviates += 1
            return self._emit("beta-deviate", arg_slots)
        if isinstance(expr, Histogram):
            self.n_deviates += 1
            return self._emit("histogram", arg_slots, len(expr.weights))
        if isinstance(expr, PeriodicTest):
            return self._emit("periodic-test", arg_slots)
        if isinstance(expr, Ite):
            return self._emit("ite", arg_slots)
        if isinstance(expr, Switch):
            return self._emit("switch", arg_slots)

        tape_op = getattr(type(expr), "tape_op", None)
        if tape_op in _ELEMENTWISE:
            return self._emit(tape_op, arg_slots)
        raise LogicError(
            f"Expression type '{type(expr).__name__}' has no tape "
            "compilation rule.")

    # ==================================================================
    # Evaluate.
    # ==================================================================

    def _leaf_groups(self) -> list[tuple]:
        """Deviates whose arguments are all constants, grouped by kind.

        A plant model has one such deviate per basic event; drawn one op
        at a time they cost tens of thousands of dispatches per call, so
        each group evaluates as one vectorized draw (``vmap`` over the
        same ``fold_in(key, slot)`` keys: the same numbers per slot).
        Entries: ``(kind, aux, slots, args)`` with ``args`` (k, arity).
        """
        if self._groups is None:
            by_kind: dict[tuple, list[int]] = {}
            for kind, slot, arg_slots, aux in self._ops:
                if kind in _LEAF_KINDS and all(
                        self._ops[s][0] == "const" for s in arg_slots):
                    by_kind.setdefault((kind, aux), []).append(slot)
            self._groups = [
                (kind, aux, np.asarray(slots),
                 np.asarray([[self._ops[a][3] for a in self._ops[s][2]]
                             for s in slots], dtype=np.float64))
                for (kind, aux), slots in by_kind.items()]
        return self._groups

    @staticmethod
    def _deviates(kind, aux, cols, slots, key, n_trials):
        """Means, or samples when ``key`` is given, of ``len(slots)``
        deviates of one leaf kind: the one sampler per kind.

        ``cols``: one array per argument, each with a leading axis of
        ``len(slots)`` that broadcasts against the (k, n_trials) draw.
        Slot ``s`` draws with ``fold_in(key, s)``.  Returns a leading-k
        array.
        """
        def draw(sampler):
            return jax.vmap(lambda s: sampler(jax.random.fold_in(key, s),
                                              (n_trials,)))(
                jnp.asarray(slots, dtype=jnp.uint32))
        if kind == "uniform-deviate":
            lo, hi = cols
            if key is None:
                return (lo + hi) / 2
            return lo + (hi - lo) * draw(jax.random.uniform)
        if kind == "normal-deviate":
            mean, sigma = cols
            if key is None:
                return mean
            return mean + sigma * draw(jax.random.normal)
        if aux == "normal":                      # lognormal (mu, sigma)
            mu, sigma = cols
            if key is None:
                return jnp.exp(mu + sigma * sigma / 2)
            return jnp.exp(mu + sigma * draw(jax.random.normal))
        mean, ef, level = cols                   # lognormal (mean, EF)
        if key is None:
            return mean
        z_level = jax.scipy.special.ndtri((1.0 + level) / 2.0)
        sigma = jnp.log(ef) / z_level
        mu = jnp.log(mean) - sigma * sigma / 2
        return jnp.exp(mu + sigma * draw(jax.random.normal))

    def _run(self, mission_time, key=None, n_trials: int | None = None):
        """Interpret the tape; sample mode iff ``key`` is given."""
        sampling = key is not None
        values: list = [None] * self._n_slots

        def deviate_key(slot: int):
            return jax.random.fold_in(key, slot)

        def draw_shape():
            return (n_trials,) if sampling else ()

        # Grouped leaf deviates: one matrix per group, rows read lazily.
        grouped: dict[int, tuple[int, int]] = {}
        matrices = []
        for g, (kind, aux, slots, args) in enumerate(self._leaf_groups()):
            trial_axis = (1,) if sampling else ()
            cols = [jnp.reshape(jnp.asarray(args[:, j]),
                                (len(slots),) + trial_axis)
                    for j in range(args.shape[1])]
            matrices.append(self._deviates(kind, aux, cols, slots, key,
                                           n_trials))
            for row, slot in enumerate(slots.tolist()):
                grouped[slot] = (g, row)

        def value(slot: int):
            if values[slot] is None and slot in grouped:
                g, row = grouped[slot]
                values[slot] = matrices[g][row]
            return values[slot]

        for kind, slot, arg_slots, aux in self._ops:
            if slot in grouped:
                continue
            if kind == "const":
                values[slot] = np.float64(aux)
                continue
            a = [value(s) for s in arg_slots]
            if kind == "mission-time":
                values[slot] = mission_time
            elif kind == "alias":
                values[slot] = a[0]
            elif kind in _LEAF_KINDS:
                values[slot] = self._deviates(
                    kind, aux, [jnp.asarray(x)[None] for x in a], [slot],
                    key, n_trials)[0]
            elif kind == "gamma-deviate":
                k, theta = a
                if sampling:
                    g = jax.random.gamma(deviate_key(slot), k, draw_shape())
                    values[slot] = g * theta
                else:
                    values[slot] = k * theta
            elif kind == "beta-deviate":
                alpha, beta = a
                if sampling:
                    values[slot] = jax.random.beta(
                        deviate_key(slot), alpha, beta, draw_shape())
                else:
                    values[slot] = alpha / (alpha + beta)
            elif kind == "histogram":
                n_bins = aux
                bounds = jnp.stack(
                    [jnp.broadcast_to(x, draw_shape()) for x in a[:n_bins + 1]],
                    axis=-1)
                weights = jnp.stack(
                    [jnp.broadcast_to(x, draw_shape()) for x in a[n_bins + 1:]],
                    axis=-1)
                mids = (bounds[..., :-1] + bounds[..., 1:]) / 2
                if sampling:
                    k1, k2 = jax.random.split(deviate_key(slot))
                    logits = jnp.log(jnp.maximum(weights, 1e-300))
                    idx = jax.random.categorical(k1, logits, axis=-1)
                    lo = jnp.take_along_axis(bounds, idx[..., None],
                                             axis=-1)[..., 0]
                    hi = jnp.take_along_axis(bounds, idx[..., None] + 1,
                                             axis=-1)[..., 0]
                    u = jax.random.uniform(k2, draw_shape())
                    values[slot] = lo + (hi - lo) * u
                else:
                    total = jnp.sum(weights, axis=-1)
                    values[slot] = jnp.sum(weights * mids, axis=-1) / total
            elif kind == "periodic-test":
                if len(a) == 4:
                    values[slot] = _periodic_test_4(*a)
                elif len(a) == 5:
                    values[slot] = _periodic_test_5(*a)
                else:
                    # 11-arg flavor: host math is exact; deviate args are
                    # not supported on the tape yet.
                    raise LogicError(
                        "The 11-argument periodic-test with stochastic/"
                        "time-traced arguments is host-evaluated only.")
            elif kind == "ite":
                cond, then_v, else_v = a
                values[slot] = jnp.where(cond != 0, then_v, else_v)
            elif kind == "switch":
                default = a[-1]
                out = jnp.asarray(default, dtype=jnp.float64)
                # Build from last case to first so earlier cases win.
                pairs = list(zip(a[:-1:2], a[1:-1:2]))
                for cond, val in reversed(pairs):
                    out = jnp.where(cond != 0, val, out)
                values[slot] = out
            else:
                values[slot] = _ELEMENTWISE[kind](*a)

        # Mean mode broadcasts to the mission-time shape (time-step
        # sweeps pass a vector of times); sample mode to the trials axis.
        # Grouped outputs leave their matrices in one gather per group.
        out_shape = draw_shape() if sampling else jnp.shape(mission_time)
        pieces, order = [], []
        for g, matrix in enumerate(matrices):
            rows = [(i, grouped[s][1]) for i, s in enumerate(self._out_slots)
                    if grouped.get(s, (None,))[0] == g]
            if rows:
                picked = matrix[np.asarray([r for _i, r in rows])]
                pieces.append(jnp.broadcast_to(
                    jnp.reshape(picked, (len(rows),) + (1,) * (
                        len(out_shape) - picked.ndim + 1) + picked.shape[1:]),
                    (len(rows),) + tuple(out_shape)))
                order += [i for i, _r in rows]
        rest = [i for i, s in enumerate(self._out_slots) if s not in grouped]
        host = [i for i in rest
                if isinstance(values[self._out_slots[i]], np.floating)]
        traced = [i for i in rest if i not in set(host)]
        if host:                  # Constants: one host-built array.
            consts = np.asarray([values[self._out_slots[i]] for i in host])
            pieces.append(jnp.broadcast_to(
                jnp.reshape(jnp.asarray(consts),
                            (len(host),) + (1,) * len(out_shape)),
                (len(host),) + tuple(out_shape)))
            order += host
        if traced:
            pieces.append(jnp.stack(
                [jnp.broadcast_to(jnp.asarray(values[self._out_slots[i]],
                                              dtype=jnp.float64), out_shape)
                 for i in traced]))
            order += traced
        if not pieces:
            return jnp.zeros(tuple(out_shape) + (0,), jnp.float64)
        stacked = jnp.concatenate(
            [piece.astype(jnp.float64) for piece in pieces], axis=0)
        if order != list(range(len(order))):
            stacked = stacked[np.argsort(np.asarray(order))]
        return jnp.moveaxis(stacked, 0, -1)

    def evaluate_mean(self, mission_time) -> jnp.ndarray:
        """Mean values, shape (n_outputs,)."""
        return self._run(jnp.asarray(mission_time, dtype=jnp.float64))

    def sample(self, key, n_trials: int, mission_time) -> jnp.ndarray:
        """Epistemic samples, shape (n_trials, n_outputs)."""
        return self._run(jnp.asarray(mission_time, dtype=jnp.float64),
                         key=key, n_trials=n_trials)
