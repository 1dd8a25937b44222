"""Common-cause failure groups (reference ``ccf_group.h:140-465``).

A CCF group replaces each member basic event with a proxy OR gate over
generated CCF events — one per k-member combination — whose probabilities
come from the group's model:

* **beta-factor**: independent (1-beta)Q at level 1 and a single
  all-members event beta*Q (ccf_group.h:320-344).
* **MGL**: level k gets ``1/C(n-1, k-1) * prod(f_1..f_{k-1}) *
  (1 - f_k) * Q`` (with the last factor omitted at the max level)
  (ccf_group.h:351-381).
* **alpha-factor**: level k gets ``k / C(n-1, k-1) * alpha_k /
  sum(j * alpha_j) * Q`` (ccf_group.h:386-416).
* **phi-factor**: level k gets ``phi_k * Q`` with the factors required to
  sum to 1 +- 1e-4 (ccf_group.h:422-458).

The expansion itself (``apply_model``) happens at model-setup time on the
host; the compiler then sees ordinary basic events and OR gates, so the
combinatorics never reach the device — they only add rows/nnz to the gate
matrix (SURVEY.md §2.6).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

from ..errors import LogicError, ValidityError
from .element import Element, RoleSpecifier
from .event import Arg, BasicEvent, Connective, Formula, Gate
from .expression import Expression, ensure_probability
from .expr.constant import ConstantExpression, ONE
from .expr.numerical import Add, Div, Mul, Sub


def _combination_reciprocal(n: int, k: int) -> float:
    """1 / C(n, k) (reference algorithm.h:230-241)."""
    return 1.0 / math.comb(n, k)


class CcfEvent(BasicEvent):
    """A generated basic event for one member combination.

    Named ``[member names]`` as in the reference (ccf_group.h CcfEvent).
    """

    kind = "CCF event"

    def __init__(self, members: list[Gate], group: "CcfGroup"):
        name = "[" + " ".join(m.name for m in members) + "]"
        BasicEvent.__init__(self, name, group.base_path, group.role)
        self.members = members
        self.group = group


class CcfGroup(Element):
    """Abstract base for CCF models."""

    kind = "CCF group"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        self.members: list[BasicEvent] = []
        self.distribution: Optional[Expression] = None
        #: (level, factor expression) pairs, densely indexed from min_level.
        self.factors: list[tuple[int, Optional[Expression]]] = []
        self._prev_level = 0
        self.ccf_events: list[CcfEvent] = []

    # -- construction ------------------------------------------------------
    def add_member(self, member: BasicEvent) -> None:
        if any(existing.id == member.id for existing in self.members):
            raise ValidityError(
                f"Duplicate member '{member.id}' in CCF group '{self.id}'.")
        if member.has_expression:
            raise ValidityError(
                f"Member '{member.id}' of CCF group '{self.id}' already has "
                "a probability expression.")
        self.members.append(member)

    def add_distribution(self, distribution: Expression) -> None:
        if self.distribution is not None:
            raise LogicError(
                f"Distribution of CCF group '{self.id}' is already set.")
        self.distribution = distribution
        # Distribution applies to all members.
        for member in self.members:
            member.expression = distribution

    def min_level(self) -> int:
        """The lowest level with a defined factor (model-dependent)."""
        return 1

    def add_factor(self, factor: Expression, level: int | None = None) -> None:
        """Add a factor at a level (reference ccf_group.h:146-176)."""
        min_level = self.min_level()
        if level is None:
            level = self._prev_level + 1 if self._prev_level else min_level
        if level <= 0 or not self.members:
            raise LogicError("Invalid CCF group factor setup.")
        if level < min_level:
            raise ValidityError(
                f"The CCF factor level ({level}) is less than the minimum "
                f"level ({min_level}).", element=self.name,
                element_type=self.kind)
        if len(self.members) < level:
            raise ValidityError(
                f"The CCF factor level {level} is more than the number of "
                f"members ({len(self.members)}).", element=self.name,
                element_type=self.kind)
        index = level - min_level
        if index < len(self.factors) and self.factors[index][1] is not None:
            raise ValidityError(
                f"Redefinition of CCF factor for level {level}.",
                element=self.name, element_type=self.kind)
        while index >= len(self.factors):
            self.factors.append((0, None))
        self.factors[index] = (level, factor)
        self._prev_level = level

    # -- validation --------------------------------------------------------
    def validate(self) -> None:
        if self.distribution is None or not self.members or not self.factors:
            raise LogicError(f"CCF group '{self.id}' is not initialized.")
        ensure_probability(self.distribution, "CCF group distribution")
        for _, factor in self.factors:
            if factor is None:
                raise ValidityError("Missing some CCF factors.",
                                    element=self.name, element_type=self.kind)
            ensure_probability(factor, "CCF group factor")
        self._do_validate()

    def _do_validate(self) -> None:
        """Model-specific extra validation."""

    # -- expansion ---------------------------------------------------------
    def calculate_probabilities(self) -> list[tuple[int, Expression]]:
        """(level, probability expression) per grouping level."""
        raise NotImplementedError

    def apply_model(self) -> None:
        """Expand members into proxy OR gates over generated CCF events
        (reference ccf_group.h:215-260)."""
        proxies: list[tuple[Gate, list[Arg]]] = []
        for member in self.members:
            gate = Gate(member.name, member.base_path, member.role)
            proxies.append((gate, []))
            member.ccf_gate = gate

        probabilities = self.calculate_probabilities()
        assert len(probabilities) > 1, "CCF must produce multiple levels."

        for level, prob in probabilities:
            for combo in itertools.combinations(range(len(proxies)), level):
                members = [proxies[i][0] for i in combo]
                ccf_event = CcfEvent(members, self)
                ccf_event.expression = prob
                for i in combo:
                    proxies[i][1].append(Arg(ccf_event))
                self.ccf_events.append(ccf_event)

        for gate, args in proxies:
            assert len(args) >= 2
            gate.formula = Formula(Connective.OR, args)

    # -- shared expression builders ---------------------------------------
    def _mul(self, args: list[Expression]) -> Expression:
        return Mul(args)


class BetaFactorModel(CcfGroup):
    """All members fail together upon common cause (ccf_group.h:320-344)."""

    def min_level(self) -> int:
        return len(self.members)

    def calculate_probabilities(self):
        assert len(self.factors) == 1
        level, beta = self.factors[0]
        assert level == len(self.members)
        q = self.distribution
        return [
            (1, Mul([Sub([ONE, beta]), q])),          # (1 - beta) * Q
            (level, Mul([beta, q])),                  # beta * Q
        ]


class MglModel(CcfGroup):
    """Multiple Greek Letters model (ccf_group.h:351-381)."""

    def min_level(self) -> int:
        return 2

    def calculate_probabilities(self):
        max_level = self.factors[-1][0]
        assert len(self.factors) == max_level - 1
        num_members = len(self.members)
        probabilities = []
        for i in range(max_level):
            mult = _combination_reciprocal(num_members - 1, i)
            args: list[Expression] = [ConstantExpression(mult)]
            for j in range(i):
                args.append(self.factors[j][1])
            if i < max_level - 1:
                args.append(Sub([ONE, self.factors[i][1]]))
            args.append(self.distribution)
            probabilities.append((i + 1, Mul(args)))
        return probabilities


class AlphaFactorModel(CcfGroup):
    """Alpha-factor model (ccf_group.h:386-416)."""

    def calculate_probabilities(self):
        max_level = self.factors[-1][0]
        assert len(self.factors) == max_level
        sum_args = [Mul([ConstantExpression(level), factor])
                    for level, factor in self.factors]
        total = Add(sum_args)
        num_members = len(self.members)
        probabilities = []
        for i in range(max_level):
            mult = _combination_reciprocal(num_members - 1, i)
            fraction = Div([self.factors[i][1], total])
            prob = Mul([ConstantExpression(i + 1), ConstantExpression(mult),
                        fraction, self.distribution])
            probabilities.append((i + 1, prob))
        return probabilities


class PhiFactorModel(CcfGroup):
    """Direct fractions: Q_k = phi_k * Q (ccf_group.h:422-458)."""

    def _do_validate(self) -> None:
        total = math.fsum(factor.value() for _, factor in self.factors)
        lo = math.fsum(factor.interval().lower for _, factor in self.factors)
        hi = math.fsum(factor.interval().upper for _, factor in self.factors)
        for value in (total, lo, hi):
            if abs(value - 1.0) > 1e-4:
                raise ValidityError(
                    "The factors for the phi-factor CCF model must sum to 1.",
                    element=self.name, element_type=self.kind)

    def calculate_probabilities(self):
        return [(level, Mul([factor, self.distribution]))
                for level, factor in self.factors]
