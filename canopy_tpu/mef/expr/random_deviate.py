"""Random deviates: the epistemic-uncertainty distributions.

Capability parity with the reference deviate set
(``/root/reference/src/mef/openpsa/expr/random_deviate.h:25-264``): uniform,
normal, lognormal (mean/EF/level and mu/sigma flavors), gamma, beta, and
histogram. ``value()`` is the analytic mean; ``interval()`` is the sample
domain used for validation.

The reference flags its own shared static ``std::mt19937`` as "not suitable
for parallelized simulations!!!" (``random_deviate.h:20-24``). The
rebuild fixes this by design: the tape compiler assigns each deviate node a
counter-based `jax.random` key folded from (analysis seed, node id), and
draws the whole trials axis in one vectorized call — deterministic under any
device count or execution order. The scalar ``_do_sample`` here (numpy
Generator) is only a host-side oracle for property tests.
"""

from __future__ import annotations

import bisect
import math

from ...errors import ValidityError
from ..expression import (Expression, Interval, ensure_non_negative,
                          ensure_positive, ensure_probability)

#: Quantile of the standard normal used for deviate sample-domain bounds.
#: 99.9th percentile — wide enough to catch domain errors, tight enough not
#: to reject routine PRA lognormals with large error factors.
_DOMAIN_Z = 3.0902323061678132  # Phi^-1(0.999)


def _phi_inv(p: float) -> float:
    """Inverse standard normal CDF (Acklam's rational approximation).

    Max absolute error ~1.15e-9 over (0, 1) — more than enough for error
    factors and domain bounds.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile argument out of range: {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= p_high:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


class RandomDeviate(Expression):
    """Base for expressions whose samples deviate from the mean."""

    def is_deviate(self) -> bool:
        return True


class UniformDeviate(RandomDeviate):
    tape_op = "uniform-deviate"

    def __init__(self, min_: Expression, max_: Expression):
        super().__init__([min_, max_])

    def value(self) -> float:
        return (self.args[0].value() + self.args[1].value()) / 2

    def validate(self) -> None:
        if self.args[0].value() >= self.args[1].value():
            raise ValidityError(
                "Uniform deviate min must be less than max: "
                f"{self.args[0].value()} >= {self.args[1].value()}")

    def interval(self) -> Interval:
        return Interval.closed(self.args[0].value(), self.args[1].value())

    def _do_sample(self, rng) -> float:
        return float(rng.uniform(self.args[0].sample(rng),
                                 self.args[1].sample(rng)))


class NormalDeviate(RandomDeviate):
    tape_op = "normal-deviate"

    def __init__(self, mean: Expression, sigma: Expression):
        super().__init__([mean, sigma])

    def value(self) -> float:
        return self.args[0].value()

    def validate(self) -> None:
        ensure_positive(self.args[1], "standard deviation")

    def interval(self) -> Interval:
        mean = self.args[0].value()
        delta = 6 * self.args[1].value()  # Reference: +-6 sigma domain.
        return Interval.closed(mean - delta, mean + delta)

    def _do_sample(self, rng) -> float:
        return float(rng.normal(self.args[0].sample(rng),
                                self.args[1].sample(rng)))


class LognormalDeviate(RandomDeviate):
    """Lognormal in either (mean, error factor, confidence level) or
    (mu, sigma) parameterization.

    For the EF flavor: ``sigma = ln(EF) / z`` with
    ``z = Phi^-1((1 + level)/2)`` (the symmetric confidence quantile), and
    ``mu = ln(mean) - sigma^2/2`` so the arithmetic mean matches the given
    mean.
    """

    tape_op = "lognormal-deviate"

    def __init__(self, *args: Expression):
        if len(args) not in (2, 3):
            raise ValidityError(
                f"Lognormal deviate takes 2 or 3 arguments, got {len(args)}.")
        super().__init__(args)
        self.flavor = "logarithmic" if len(args) == 3 else "normal"

    # -- distribution parameters ------------------------------------------
    def _scale(self) -> float:
        """The underlying normal's sigma."""
        if self.flavor == "normal":
            return self.args[1].value()
        ef = self.args[1].value()
        level = self.args[2].value()
        return math.log(ef) / _phi_inv((1 + level) / 2)

    def _location(self) -> float:
        """The underlying normal's mu."""
        if self.flavor == "normal":
            return self.args[0].value()
        sigma = self._scale()
        return math.log(self.args[0].value()) - sigma * sigma / 2

    def value(self) -> float:
        if self.flavor == "logarithmic":
            return self.args[0].value()
        mu, sigma = self.args[0].value(), self.args[1].value()
        return math.exp(mu + sigma * sigma / 2)

    def validate(self) -> None:
        if self.flavor == "logarithmic":
            mean, ef, level = self.args
            if not (0.0 < level.value() < 1.0):
                raise ValidityError(
                    f"The confidence level must be in (0, 1): {level.value()}")
            if ef.value() <= 1.0:
                raise ValidityError(
                    f"The error factor must be greater than 1: {ef.value()}")
            ensure_positive(mean, "lognormal mean")
        else:
            ensure_positive(self.args[1], "lognormal scale (sigma)")

    def interval(self) -> Interval:
        mu, sigma = self._location(), self._scale()
        return Interval.closed(math.exp(mu - _DOMAIN_Z * sigma),
                               math.exp(mu + _DOMAIN_Z * sigma))

    def _do_sample(self, rng) -> float:
        if self.flavor == "normal":
            mu = self.args[0].sample(rng)
            sigma = self.args[1].sample(rng)
        else:
            mean = self.args[0].sample(rng)
            ef = self.args[1].sample(rng)
            level = self.args[2].sample(rng)
            sigma = math.log(ef) / _phi_inv((1 + level) / 2)
            mu = math.log(mean) - sigma * sigma / 2
        return float(rng.lognormal(mu, sigma))


class GammaDeviate(RandomDeviate):
    """Gamma with shape k and scale theta; mean = k * theta."""

    tape_op = "gamma-deviate"

    def __init__(self, k: Expression, theta: Expression):
        super().__init__([k, theta])

    def value(self) -> float:
        return self.args[0].value() * self.args[1].value()

    def validate(self) -> None:
        ensure_positive(self.args[0], "gamma shape")
        ensure_positive(self.args[1], "gamma scale")

    def interval(self) -> Interval:
        k, theta = self.args[0].value(), self.args[1].value()
        mean = k * theta
        std = math.sqrt(k) * theta
        return Interval.closed(0.0, mean + _DOMAIN_Z * std)

    def _do_sample(self, rng) -> float:
        return float(rng.gamma(self.args[0].sample(rng),
                               self.args[1].sample(rng)))


class BetaDeviate(RandomDeviate):
    tape_op = "beta-deviate"

    def __init__(self, alpha: Expression, beta: Expression):
        super().__init__([alpha, beta])

    def value(self) -> float:
        a, b = self.args[0].value(), self.args[1].value()
        return a / (a + b)

    def validate(self) -> None:
        ensure_positive(self.args[0], "beta shape alpha")
        ensure_positive(self.args[1], "beta shape beta")

    def interval(self) -> Interval:
        return Interval.closed(0.0, 1.0)

    def _do_sample(self, rng) -> float:
        return float(rng.beta(self.args[0].sample(rng),
                              self.args[1].sample(rng)))


class Histogram(RandomDeviate):
    """Piecewise-uniform distribution over weighted bins.

    ``boundaries`` has one more entry than ``weights``; bin *i* spans
    [boundaries[i], boundaries[i+1]] with unnormalized weight weights[i].
    """

    tape_op = "histogram"

    def __init__(self, boundaries: list[Expression], weights: list[Expression]):
        if len(boundaries) != len(weights) + 1:
            raise ValidityError(
                "Histogram requires one more boundary than weights: "
                f"{len(boundaries)} boundaries, {len(weights)} weights.")
        super().__init__(list(boundaries) + list(weights))
        self.boundaries = list(boundaries)
        self.weights = list(weights)

    def value(self) -> float:
        bounds = [b.value() for b in self.boundaries]
        weights = [w.value() for w in self.weights]
        total = math.fsum(weights)
        acc = math.fsum(w * (lo + hi) / 2
                        for w, lo, hi in zip(weights, bounds, bounds[1:]))
        return acc / total

    def validate(self) -> None:
        bounds = [b.value() for b in self.boundaries]
        for lo, hi in zip(bounds, bounds[1:]):
            if hi <= lo:
                raise ValidityError(
                    "Histogram boundaries must be strictly increasing: "
                    f"{lo} >= {hi}")
        for weight in self.weights:
            ensure_non_negative(weight, "histogram weight")
        if math.fsum(w.value() for w in self.weights) <= 0:
            raise ValidityError("Histogram weights must not all be zero.")

    def interval(self) -> Interval:
        return Interval.closed(self.boundaries[0].value(),
                               self.boundaries[-1].value())

    def _do_sample(self, rng) -> float:
        bounds = [b.sample(rng) for b in self.boundaries]
        weights = [w.sample(rng) for w in self.weights]
        total = math.fsum(weights)
        u = rng.uniform(0.0, total)
        cumulative = []
        acc = 0.0
        for w in weights:
            acc += w
            cumulative.append(acc)
        idx = min(bisect.bisect_left(cumulative, u), len(weights) - 1)
        return float(rng.uniform(bounds[idx], bounds[idx + 1]))
