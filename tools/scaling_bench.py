#!/usr/bin/env python
"""Weak-scaling harness: nnz/s at 1..N devices (BASELINE.md table).

On the CPU backend this exercises the sharded code paths over virtual
devices (functional validation of the scaling story); on a multi-GPU host
the same script measures NVLink scaling. Trials per device stay constant (weak
scaling); efficiency = throughput(N) / (N * throughput(1)).

Usage:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS"):
    # Set the config value too, so a platform chosen earlier in the
    # process cannot win over the documented env-var usage.
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp

    from canopy_tpu.parallel.mesh import make_mesh
    from canopy_tpu.parallel.quantify import sharded_uncertainty_step
    from canopy_tpu.utils.synthetic import synthetic_compiled_tree

    trials_per_device = int(os.environ.get("SCALE_TRIALS", "128"))
    n_gates = int(os.environ.get("SCALE_GATES", "20000"))
    tree = synthetic_compiled_tree(n_basic=2048, n_gates=n_gates, fanin=4,
                                   n_levels=10, seed=0)
    devices = jax.devices()
    house = jnp.zeros((tree.n_house,))
    results = []
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    rng = np.random.default_rng(0)
    for n in counts:
        mesh = make_mesh(devices[:n])
        step = sharded_uncertainty_step(tree, mesh)
        n_trials = trials_per_device * n
        batch = jnp.asarray(rng.uniform(0, 0.05, (n_trials, tree.n_basic)),
                            dtype=jnp.float32)
        step(batch, house).block_until_ready()   # Compile.
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(batch, house)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        throughput = tree.nnz * n_trials / dt
        results.append({"devices": n, "trials": n_trials,
                        "seconds": dt, "nnz_trials_per_s": throughput})
        base = results[0]["nnz_trials_per_s"]
        eff = throughput / (n * base)
        print(f"devices={n:2d} {throughput/1e9:8.2f} G/s "
              f"efficiency={eff:.2f}", file=sys.stderr)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
