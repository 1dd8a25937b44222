"""Device mesh construction for quantification workloads.

The workload's native parallel axes (SURVEY.md §2.6):

* ``data`` — the sample/trials axis (uncertainty trials, MC states):
  embarrassingly parallel, so it takes most of the mesh.
* ``model`` — row/block partition of gate-structure and cut-set matrices
  (the tensor-parallel analogue); partial sums meet in a `psum`.

Pipeline parallelism maps to gate levels (deep trees) and is planned on
top of the same mesh; sequence/context/expert parallelism have no
workload analogue (documented N/A — there is no sequence dimension).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "mesh_shape"]


def mesh_shape(n_devices: int, model_parallelism: int | None = None
               ) -> tuple[int, int]:
    """(data, model) factorization of the device count.

    Defaults to the largest power-of-two model axis not exceeding
    sqrt(n); sampling throughput dominates, so data gets the rest.
    """
    if model_parallelism is not None:
        if n_devices % model_parallelism:
            raise ValueError(
                f"model_parallelism {model_parallelism} does not divide "
                f"device count {n_devices}")
        return n_devices // model_parallelism, model_parallelism
    model = 1
    while model * 2 <= max(1, int(np.sqrt(n_devices))) and \
            n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


def make_mesh(devices=None, model_parallelism: int | None = None) -> Mesh:
    """A ("data", "model") mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    data, model = mesh_shape(n, model_parallelism)
    device_array = np.asarray(devices).reshape(data, model)
    return Mesh(device_array, ("data", "model"))
