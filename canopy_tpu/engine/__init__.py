"""Quantification engines: JAX/XLA compute paths."""

from .propagate import (make_propagator, propagate_probability,  # noqa: F401
                        top_event_probability)
from .analysis import Report, RiskAnalysis  # noqa: F401
