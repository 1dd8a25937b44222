"""Observability: phase timers and per-kernel roofline accounting.

The reference stripped all its logging/timing during the SCRAM port
(SURVEY.md §5: ``//CLOCK``/``//LOG`` remnants). This module restores it
with structured phase timers (feeding ``RiskAnalysis`` timings and
the report's ``<performance>`` section), a roofline accountant that turns
(bytes moved, elements processed, elapsed) into achieved-fraction
numbers, and an optional `jax.profiler` trace context for TensorBoard.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["PhaseTimer", "RooflineAccountant", "trace"]


class PhaseTimer:
    """Accumulating named phase timers."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self.times)


class RooflineAccountant:
    """Tracks kernel throughput against the device-memory roofline.

    Peaks come from :data:`canopy_tpu.device.PEAKS` (keyed by
    ``device_kind``, default: the first JAX device); an unknown device
    raises instead of borrowing another device's numbers.
    """

    def __init__(self, device_kind: str | None = None):
        from ..device import peaks
        self.bandwidth = peaks(device_kind).hbm_bytes_per_s
        self.records: list[dict] = []

    def record(self, name: str, elements: int, bytes_per_element: float,
               seconds: float) -> dict:
        ideal = elements * bytes_per_element / self.bandwidth
        entry = {
            "kernel": name,
            "elements": elements,
            "seconds": seconds,
            "elements_per_s": elements / seconds if seconds else 0.0,
            "hbm_fraction": ideal / seconds if seconds else 0.0,
        }
        self.records.append(entry)
        return entry

    def report(self) -> list[dict]:
        return list(self.records)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """`jax.profiler` trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
