"""Pipeline parallelism over gate levels (GPipe-style, on a "pipe" axis).

The third parallel axis of SURVEY.md §2.6's mapping (batch ≈ dp, matrix
partition ≈ tp, **gate levels ≈ pp**): the level schedule is split into
contiguous *stages* balanced by nnz, each stage owned by one device along
the mesh's ``pipe`` axis; the trials axis is split into *microbatches*
that flow through the stages. At steady state every stage computes a
different microbatch — deep trees stop serializing the whole chip count
on one level at a time.

SPMD uniformity (one program for all stages) comes from compiling every
stage to the same padded shape: per (stage, virtual level) an ELL block
of ``(G_max, F_max)`` argument slots, with padded rows writing to an
out-of-range slot that a ``mode="drop"`` scatter discards, and padded
levels/stages degenerating to no-ops. Stage arrays are sharded over
``pipe`` so each device reads only its own microcode.

Per step, the in-flight value buffer ``(n_nodes, T_micro)`` moves one
stage forward with a neighbor `ppermute` — on GPUs an NCCL send over
NVLink — and overlaps with the next microbatch's compute
in XLA's schedule (send happens once per step, compute fills the rest).

This engine exists for *depth*: wall-clock per level is latency-bound
once levels get narrow (the top of every real tree), and the pipeline
hides that latency across microbatches. For wide shallow trees the
``data``/``model`` axes (``parallel/quantify.py`` / ``partition.py``)
remain the right choice; the axes compose (``pipe`` x ``data`` here).

Results are bit-identical to the single-device gather engine (same
multiplies, same order, per microbatch).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..compiler.graph import CompiledTree
from ..errors import LogicError

__all__ = ["make_pipeline_propagator", "make_pipe_mesh", "plan_stages"]


def make_pipe_mesh(devices=None, pipe: int | None = None,
                   data: int = 1) -> Mesh:
    """A ("data", "pipe") mesh; default: all devices on the pipe axis."""
    if devices is None:
        devices = jax.devices()
    if pipe is None:
        pipe = len(devices) // data
    device_array = np.asarray(devices).reshape(data, pipe)
    return Mesh(device_array, ("data", "pipe"))


@dataclasses.dataclass
class _LevelCode:
    out_start: int
    n_gates: int
    arg_idx: np.ndarray    # (G, F)
    arg_flip: np.ndarray
    arg_mask: np.ndarray
    inv_out: np.ndarray    # (G,)

    @property
    def nnz(self) -> int:
        return int(self.arg_mask.sum())


def _merge_level(level) -> _LevelCode:
    from ..compiler.graph import merge_prod_level

    merged = merge_prod_level(level)
    return _LevelCode(int(merged.out_idx[0]), merged.n_gates,
                      merged.arg_idx, merged.arg_flip, merged.arg_mask,
                      merged.inv_out)


def plan_stages(tree: CompiledTree, n_stages: int) -> list[list[_LevelCode]]:
    """Split the level schedule into ``n_stages`` contiguous chunks with
    (approximately) balanced nnz: boundaries at the ideal cumulative-nnz
    split points."""
    codes = [_merge_level(level) for level in tree.levels
             if any(b.n_gates for b in level.prods)]
    if not codes:
        raise LogicError("tree has no gate levels")
    cum = np.cumsum([c.nnz for c in codes], dtype=np.float64)
    total = cum[-1]
    bounds = [0]
    for s in range(1, n_stages):
        b = int(np.searchsorted(cum, total * s / n_stages))
        bounds.append(max(b, bounds[-1]))
    bounds.append(len(codes))
    return [codes[bounds[s]:bounds[s + 1]] for s in range(n_stages)]


def make_pipeline_propagator(tree: CompiledTree, mesh: Mesh,
                             n_micro: int | None = None,
                             axis: str = "pipe"):
    """jitted ``(basic_p (T, n_basic), house (n_house,)) -> top (T,)``.

    ``T`` must be divisible by ``n_micro`` (times the ``data`` axis size
    when the mesh has one). ``n_micro`` defaults to 2x the stage count
    (half-bubble at steady state).
    """
    if tree.top_index is None:
        raise LogicError("tree has no top index")
    n_stages = mesh.shape[axis]
    n_micro = n_micro or 2 * n_stages
    stages = plan_stages(tree, n_stages)

    l_max = max(len(chunk) for chunk in stages)
    g_max = max((c.n_gates for chunk in stages for c in chunk), default=1)
    f_max = max((c.arg_idx.shape[1] for chunk in stages for c in chunk),
                default=1)
    n_nodes = tree.n_nodes

    # Padded microcode: (S, L_max, ...); padded rows scatter to slot
    # n_nodes (out of range -> dropped), padded levels have no real rows.
    out_slots = np.full((n_stages, l_max, g_max), n_nodes, dtype=np.int32)
    arg_idx = np.zeros((n_stages, l_max, g_max, f_max), dtype=np.int32)
    arg_flip = np.zeros((n_stages, l_max, g_max, f_max), dtype=bool)
    arg_mask = np.zeros((n_stages, l_max, g_max, f_max), dtype=bool)
    inv_out = np.zeros((n_stages, l_max, g_max), dtype=bool)
    for s, chunk in enumerate(stages):
        for j, code in enumerate(chunk):
            g, f = code.arg_idx.shape
            out_slots[s, j, :g] = code.out_start + np.arange(g)
            arg_idx[s, j, :g, :f] = code.arg_idx
            arg_flip[s, j, :g, :f] = code.arg_flip
            arg_mask[s, j, :g, :f] = code.arg_mask
            inv_out[s, j, :g] = code.inv_out

    operands = tuple(jnp.asarray(a) for a in
                     (out_slots, arg_idx, arg_flip, arg_mask, inv_out))
    operand_specs = tuple(P(axis, *([None] * (a.ndim - 1)))
                          for a in operands)
    has_data = "data" in mesh.axis_names and mesh.shape["data"] > 1
    data_spec = "data" if has_data else None
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def local_fn(basic_nm, house_nm, slots, aidx, aflip, amask, ainv):
        # Local views: microcode has leading stage dim 1.
        slots, aidx, aflip, amask, ainv = (
            x[0] for x in (slots, aidx, aflip, amask, ainv))
        s = jax.lax.axis_index(axis)
        t_local = basic_nm.shape[1]
        if t_local % n_micro:
            raise LogicError(
                f"trials per data shard ({t_local}) must be divisible by "
                f"n_micro ({n_micro})")
        t_micro = t_local // n_micro
        dtype = basic_nm.dtype

        def fresh(m):
            b = jax.lax.dynamic_slice(
                basic_nm, (0, m * t_micro), (tree.n_basic, t_micro))
            parts = [b]
            if tree.n_house:
                parts.append(jnp.broadcast_to(
                    house_nm[:, None], (tree.n_house, t_micro))
                    .astype(dtype))
            parts.append(jnp.zeros((tree.n_gates, t_micro), dtype=dtype))
            return jnp.concatenate(parts, axis=0)

        def eval_level(buf, j):
            acc = None
            for f in range(f_max):
                v = buf[aidx[j, :, f]]
                x = jnp.where(aflip[j, :, f][:, None], 1.0 - v, v)
                x = jnp.where(amask[j, :, f][:, None], x, 1.0)
                acc = x if acc is None else acc * x
            out = jnp.where(ainv[j][:, None], 1.0 - acc, acc)
            return buf.at[slots[j]].set(out.astype(buf.dtype),
                                        mode="drop")

        def step(t, carry):
            buf, collected = carry
            m_in = jnp.minimum(t, n_micro - 1)
            buf = jnp.where(s == 0, fresh(m_in), buf)
            for j in range(l_max):
                buf = eval_level(buf, j)
            m_out = t - (n_stages - 1)
            top_row = buf[tree.top_index]
            updated = jax.lax.dynamic_update_slice(
                collected, top_row[None, :],
                (jnp.maximum(m_out, 0), 0))
            collected = jnp.where((s == n_stages - 1) & (m_out >= 0),
                                  updated, collected)
            buf = jax.lax.ppermute(buf, axis, ring)
            return buf, collected

        buf0 = jnp.zeros((n_nodes, t_micro), dtype=dtype)
        out0 = jnp.zeros((n_micro, t_micro), dtype=dtype)
        _, collected = jax.lax.fori_loop(0, n_micro + n_stages - 1, step,
                                         (buf0, out0))
        # Only the last stage holds real results; share along the ring.
        collected = jax.lax.psum(
            jnp.where(s == n_stages - 1, collected, 0), axis)
        return collected.reshape(t_local)

    # check_vma off: the carry starts unvarying and becomes pipe-varying
    # inside the loop (axis_index selects + ppermute), which the static
    # varying-axis checker cannot express (same as parallel/partition.py).
    try:
        sharded = shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, data_spec), P(None), *operand_specs),
            out_specs=P(data_spec), check_vma=False)
    except TypeError:  # pragma: no cover - older jax spelling
        sharded = shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, data_spec), P(None), *operand_specs),
            out_specs=P(data_spec), check_rep=False)

    @jax.jit
    def propagate(basic_p, house):
        return sharded(basic_p.T, house, *operands)

    return propagate
