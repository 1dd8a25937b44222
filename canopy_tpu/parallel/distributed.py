"""Multi-host initialization and failure-tolerant run loops.

The reference has no distributed backend (SURVEY.md §5: SYCL multi-device
was planned, never built; CI's ``|| true`` is the opposite of failure
detection). JAX's runtime *is* the backend (XLA hands collectives to
NCCL on GPUs), so this module is thin by design:

* :func:`initialize` — `jax.distributed.initialize`, with the
  coordinator address, process count and id passed explicitly.
  The coordinator heartbeat that `jax.distributed` maintains is the
  failure detector: a lost host fails the step with a distributed
  runtime error instead of hanging.
* :func:`run_resilient` — wraps a checkpointed sweep
  (``engine/checkpoint.py``) with restart-on-preemption semantics: on a
  retryable failure the loop reloads the last checkpoint and continues;
  determinism of counter-based batch keys makes the retried run
  bit-identical.
"""

from __future__ import annotations

import time

__all__ = ["initialize", "run_resilient"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize `jax.distributed` (no-op when single-process).

    Nothing on a single GPU host describes a cluster, so pass
    ``coordinator_address`` (e.g. ``localhost:<port>``), ``num_processes``
    and ``process_id`` explicitly
    (`--xla_force_host_platform_device_count` covers single-process mesh
    tests without this).
    """
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        return  # Single-process: nothing to coordinate.
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def run_resilient(sweep_factory, max_restarts: int = 3,
                  backoff_seconds: float = 5.0):
    """Run a checkpointed sweep, restarting after retryable failures.

    ``sweep_factory()`` must build a fresh
    :class:`~canopy_tpu.engine.checkpoint.CheckpointedSweep` (re-reading
    its checkpoint) on every call. Returns the final state.
    """
    from jax.errors import JaxRuntimeError

    attempts = 0
    while True:
        try:
            return sweep_factory().run()
        except JaxRuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
            time.sleep(backoff_seconds * attempts)
