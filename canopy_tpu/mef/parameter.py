"""Parameters: named shareable expressions (reference ``parameter.h:14-106``)."""

from __future__ import annotations

import enum
from typing import Optional

from ..errors import LogicError
from .element import Element, RoleSpecifier
from .expression import Expression, Interval


class Units(enum.IntEnum):
    """Physical units for parameters (reference parameter.h:14-32)."""

    UNITLESS = 0
    BOOL = 1
    INT = 2
    FLOAT = 3
    HOURS = 4
    INVERSE_HOURS = 5
    YEARS = 6
    INVERSE_YEARS = 7
    FIT = 8
    DEMANDS = 9


UNIT_NAMES = ["unitless", "bool", "int", "float", "hours", "hours-1",
              "years", "years-1", "fit", "demands"]
UNIT_BY_NAME = {name: Units(i) for i, name in enumerate(UNIT_NAMES)}


class MissionTime(Expression):
    """The mission-time expression shared across the model.

    A mutable leaf: the analysis driver sets its value (from settings or a
    time-step sweep) and every dependent expression sees it. Compiled to a
    broadcast scalar input of the device tape so time-stepped analyses re-use
    one compiled program.
    """

    tape_op = "mission-time"

    def __init__(self, value: float = 8760.0):
        super().__init__()
        self._value = value
        self.unit = Units.HOURS

    def value(self) -> float:
        return self._value

    def set_value(self, value: float) -> None:
        if value < 0:
            raise LogicError(f"Mission time cannot be negative: {value}")
        self._value = value

    def _compute(self):  # pragma: no cover - value() overridden
        return self._value

    def interval(self) -> Interval:
        return Interval.closed(0.0, self._value)

    def is_deviate(self) -> bool:
        return False

    def _do_sample(self, rng) -> float:
        return self._value


class Parameter(Element, Expression):
    """A named, shareable expression with a unit (reference parameter.h:35-106)."""

    kind = "parameter"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        Element.__init__(self, name, base_path, role)
        Expression.__init__(self)
        self.unit = Units.UNITLESS
        self._expression: Optional[Expression] = None

    @property
    def expression(self) -> Optional[Expression]:
        return self._expression

    @expression.setter
    def expression(self, expr: Expression) -> None:
        if self._expression is not None:
            raise LogicError(f"Parameter '{self.id}' expression is already set.")
        self._expression = expr
        self.args = [expr]

    def value(self) -> float:
        if self._expression is None:
            raise LogicError(f"Parameter '{self.id}' has no expression.")
        return self._expression.value()

    def _compute(self, value: float) -> float:
        return value

    def interval(self) -> Interval:
        return self._expression.interval()
