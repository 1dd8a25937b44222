"""Profiling + distributed helper tests."""

import time

import numpy as np
import pytest

from canopy_tpu.parallel.distributed import initialize, run_resilient
from canopy_tpu.utils.profiling import (PhaseTimer, RooflineAccountant,
                                        trace)


class TestPhaseTimer:
    def test_accumulates(self):
        timer = PhaseTimer()
        with timer.phase("a"):
            time.sleep(0.01)
        with timer.phase("a"):
            pass
        with timer.phase("b"):
            pass
        report = timer.report()
        assert report["a"] >= 0.01
        assert timer.counts["a"] == 2
        assert "b" in report


class TestRoofline:
    def test_fraction(self):
        acc = RooflineAccountant("NVIDIA H100 80GB HBM3")
        entry = acc.record("spmm", elements=3_350_000_000,
                           bytes_per_element=4.0, seconds=8.0)
        # 3.35e9 * 4B / 3.35e12 B/s = 4 ms ideal; 8 s actual -> 5e-4.
        assert abs(entry["hbm_fraction"] - 0.0005) < 1e-6
        assert len(acc.report()) == 1


class TestTrace:
    def test_noop(self):
        with trace(None):
            pass


class TestDistributed:
    def test_single_process_noop(self):
        initialize()  # Must not raise or try to connect anywhere.

    def test_run_resilient_retries(self):
        calls = []

        class FakeSweep:
            def __init__(self, fail):
                self.fail = fail

            def run(self):
                if self.fail:
                    from jax.errors import JaxRuntimeError
                    raise JaxRuntimeError("preempted")
                return "done"

        def factory():
            calls.append(1)
            return FakeSweep(fail=len(calls) < 3)

        result = run_resilient(factory, max_restarts=5,
                               backoff_seconds=0.001)
        assert result == "done"
        assert len(calls) == 3

    def test_run_resilient_gives_up(self):
        from jax.errors import JaxRuntimeError

        class AlwaysFails:
            def run(self):
                raise JaxRuntimeError("dead")

        with pytest.raises(JaxRuntimeError):
            run_resilient(lambda: AlwaysFails(), max_restarts=1,
                          backoff_seconds=0.001)
