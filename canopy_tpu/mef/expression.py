"""Expression system core: values, intervals, domains, and sampling protocol.

Capability parity with the reference expression layer
(``/root/reference/src/mef/openpsa/expression.h:20-368``):

* :class:`Interval` — validation domains with open/closed bounds.
* :class:`Expression` — abstract base with ``value()`` (the mean),
  ``interval()`` (the sample domain), ``validate()``, ``is_deviate()``, and
  the memoize/reset scalar sampling protocol (``expression.h:98-117``) that
  guarantees *consistent per-trial samples for shared parameters*.
* Domain validators ``ensure_probability`` / ``ensure_positive`` /
  ``ensure_non_negative`` / ``ensure_within`` (``expression.h:292-368``).

Device note: the scalar ``value()``/``sample()`` interpreter here exists for
validation and host-side oracles. Production evaluation happens through
:mod:`canopy_tpu.compiler.expr_tape`, which compiles the expression DAG into
a static SSA tape executed as one fused, batched JAX program over a trials
axis — each deviate node is evaluated exactly once per trial batch, which
preserves the memoize-per-trial semantics by construction and replaces the
reference's shared serial RNG (``expr/random_deviate.h:20-24``) with
counter-based per-node `jax.random` keys.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Iterable

from ..errors import DomainError

__all__ = ["Interval", "Expression", "ensure_probability", "ensure_positive",
           "ensure_non_negative", "ensure_within"]


class Interval:
    """A continuous interval with open/closed bounds, for domain validation."""

    __slots__ = ("lower", "upper", "lower_closed", "upper_closed")

    def __init__(self, lower: float, upper: float,
                 lower_closed: bool = True, upper_closed: bool = True):
        self.lower = lower
        self.upper = upper
        self.lower_closed = lower_closed
        self.upper_closed = upper_closed

    @classmethod
    def closed(cls, lower: float, upper: float) -> "Interval":
        return cls(lower, upper, True, True)

    @classmethod
    def open(cls, lower: float, upper: float) -> "Interval":
        return cls(lower, upper, False, False)

    @classmethod
    def left_open(cls, lower: float, upper: float) -> "Interval":
        return cls(lower, upper, False, True)

    @classmethod
    def right_open(cls, lower: float, upper: float) -> "Interval":
        return cls(lower, upper, True, False)

    @classmethod
    def point(cls, value: float) -> "Interval":
        return cls(value, value, True, True)

    def contains(self, value: float) -> bool:
        if value < self.lower or value > self.upper:
            return False
        if value == self.lower and not self.lower_closed:
            return False
        if value == self.upper and not self.upper_closed:
            return False
        return True

    def within(self, other: "Interval") -> bool:
        """True if this interval is entirely inside ``other``."""
        if self.lower < other.lower or self.upper > other.upper:
            return False
        if self.lower == other.lower and self.lower_closed and not other.lower_closed:
            return False
        if self.upper == other.upper and self.upper_closed and not other.upper_closed:
            return False
        return True

    @property
    def is_probability(self) -> bool:
        return self.within(Interval.closed(0.0, 1.0))

    @property
    def is_non_negative(self) -> bool:
        return self.lower >= 0

    @property
    def is_positive(self) -> bool:
        return self.is_non_negative and not self.contains(0.0)

    def __repr__(self) -> str:  # pragma: no cover
        lo = "[" if self.lower_closed else "("
        hi = "]" if self.upper_closed else ")"
        return f"{lo}{self.lower}, {self.upper}{hi}"


class Expression:
    """Abstract base for all MEF expressions.

    Subclasses define ``_compute(*arg_values)`` (the scalar math) and may
    override ``interval()``, ``validate()``, ``is_deviate()`` and
    ``_do_sample(rng)``.
    """

    def __init__(self, args: Iterable["Expression"] = ()):
        self.args: list[Expression] = list(args)
        self._sampled = False
        self._sampled_value = 0.0

    # -- mean value --------------------------------------------------------
    def value(self) -> float:
        """The mean value of the expression."""
        return self._compute(*(arg.value() for arg in self.args))

    def _compute(self, *values: float) -> float:
        raise NotImplementedError

    # -- domain ------------------------------------------------------------
    def interval(self) -> Interval:
        """The domain of the expression's samples (default: its point value)."""
        return Interval.point(self.value())

    def validate(self) -> None:
        """Late validation of argument domains (default: nothing)."""

    # -- sampling protocol (scalar oracle; device path is the tape) -------
    def is_deviate(self) -> bool:
        """True if the value deviates from the mean (needs sampling)."""
        return any(arg.is_deviate() for arg in self.args)

    def sample(self, rng) -> float:
        """Memoized per-trial sample (reference expression.h:98-104)."""
        if not self._sampled:
            self._sampled = True
            self._sampled_value = self._do_sample(rng)
        return self._sampled_value

    def reset(self) -> None:
        """Recursively un-memoize for the next trial (expression.h:110-117)."""
        if not self._sampled:
            return
        self._sampled = False
        for arg in self.args:
            arg.reset()

    def _do_sample(self, rng) -> float:
        return self._compute(*(arg.sample(rng) for arg in self.args))


# ---------------------------------------------------------------------------
# Interval propagation helpers for composite expressions.
# ---------------------------------------------------------------------------

def corner_interval(fn: Callable[..., float],
                    intervals: list[Interval]) -> Interval:
    """Propagate intervals through ``fn`` by corner evaluation.

    Exact for ops monotone in each argument (the reference makes the same
    assumption: ``expression.h:163-284`` evaluates min/max over interval
    corners). For > 3 arguments the reduction is applied pairwise
    left-to-right, which stays exact for associative monotone ops.
    """
    if not intervals:
        value = fn()
        return Interval.point(value)
    if len(intervals) <= 3:
        corners = [(iv.lower, iv.upper) for iv in intervals]
        values = [fn(*combo) for combo in itertools.product(*corners)]
        return Interval.closed(min(values), max(values))
    # Pairwise reduce for wide n-ary expressions.
    acc = intervals[0]
    for nxt in intervals[1:]:
        values = [fn_pairwise_guard(fn, a, b)
                  for a in (acc.lower, acc.upper)
                  for b in (nxt.lower, nxt.upper)]
        acc = Interval.closed(min(values), max(values))
    return acc


def fn_pairwise_guard(fn: Callable[..., float], a: float, b: float) -> float:
    return fn(a, b)


# ---------------------------------------------------------------------------
# Domain validators (reference expression.h:292-368).
# ---------------------------------------------------------------------------

def ensure_probability(expression: Expression,
                       description: str = "probability") -> None:
    value = expression.value()
    if not (0.0 <= value <= 1.0) or math.isnan(value):
        raise DomainError(f"Invalid {description} value {value}")
    if not expression.interval().is_probability:
        raise DomainError(
            f"Invalid {description} sample domain {expression.interval()}")


def ensure_positive(expression: Expression, description: str) -> None:
    if expression.value() <= 0:
        raise DomainError(
            f"{description} argument value must be positive: {expression.value()}")
    if not expression.interval().is_positive:
        raise DomainError(
            f"{description} argument sample domain must be positive "
            f"{expression.interval()}")


def ensure_non_negative(expression: Expression, description: str) -> None:
    if expression.value() < 0:
        raise DomainError(
            f"{description} argument value cannot be negative: "
            f"{expression.value()}")
    if not expression.interval().is_non_negative:
        raise DomainError(
            f"{description} argument sample cannot have negative values "
            f"{expression.interval()}")


def ensure_within(expression: Expression, interval: Interval,
                  description: str) -> None:
    if not interval.contains(expression.value()):
        raise DomainError(
            f"{description} argument value must be in {interval}: "
            f"{expression.value()}")
    if not expression.interval().within(interval):
        raise DomainError(
            f"{description} argument sample domain must be in {interval}: "
            f"{expression.interval()}")
