#!/usr/bin/env python
"""Benchmark harness: batched gate-propagation throughput vs the
device-memory roofline, on one GPU, in one process.

Measures the flagship compute path — bottom-up probability propagation of a
synthetic benchmark-scale fault tree, batched over a trials axis (the SpMM
configuration of BASELINE.json config 2/3) — and reports effective
nnz x trials processed per second against the card's memory roofline for
the gather-dominated access pattern (peaks: ``canopy_tpu.device.PEAKS``,
keyed by ``device_kind``; an unknown device raises).

Sections: ``gather`` (the 400k-gate uniform tree), ``config3-1M``,
``gather-bf16``, ``mc-bitpacked`` and ``bsr``.  Details go to stderr; the
last stdout line is one JSON object.  ``--rehearse`` runs on any backend
(e.g. the CPU at tiny ``BENCH_*`` sizes) and reports no roofline share.

Harness discipline (every section):

* Iterations chain inside one jitted ``fori_loop`` reduced to a scalar —
  one dispatch, one device-to-host transfer, so asynchronous dispatch
  cannot fake the timing.  ``n_iter`` is a *traced* argument, so one
  compile serves every iteration count.
* Every loop body is made loop-variant by carrying the input through the
  loop and perturbing one column per iteration, so XLA cannot hoist the
  propagation out of the loop.
* Differenced timings are validated: the span between the two iteration
  counts must exceed timer noise, and the value must stay under ``cap``
  x the roofline; otherwise the span doubles, and persistent failure
  raises instead of publishing.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

#: Physical plausibility cap, in multiples of the gather-formulation
#: memory roofline.
_CAP = 50.0

_sections: dict[str, dict] = {}
_failed: dict[str, str] = {}


def _record(name, value, unit, dt, iters_used):
    _sections[name] = {"value": value, "unit": unit,
                       "ms_per_iter": dt * 1e3, "iters": iters_used}


def measure(timed, iters, *, name, work=None, roofline=None, cap=_CAP,
            retries=3):
    """Difference two iteration counts with validation.

    ``timed(n_iter)`` returns the best-of-3 wall time for ``n_iter``
    chained iterations.  The differenced span must exceed timer noise
    (2 ms and 2% of the small run) and, when ``work`` and ``roofline``
    are given, the implied value must stay under ``cap`` x roofline.
    Invalid timings retry with a doubled span (n_iter is traced — no
    recompile); persistent failure raises instead of publishing.
    """
    for attempt in range(retries):
        t_small = timed(2)
        t_large = timed(2 + iters)
        span = t_large - t_small
        if span >= max(2e-3, 0.02 * t_small):
            dt = span / iters
            value = None if work is None else work / dt
            if value is None or roofline is None \
                    or value <= cap * roofline:
                return dt, iters
            reason = (f"value {value:.3e} exceeds "
                      f"{cap:g}x roofline {roofline:.3e}")
        else:
            reason = (f"differenced span {span * 1e3:.3f} ms not "
                      f"resolvable over {iters} iters "
                      f"(small={t_small * 1e3:.1f} ms)")
        print(f"bench[{name}]: implausible timing ({reason}); "
              f"retrying with {iters * 2} iters", file=sys.stderr)
        iters *= 2
    raise RuntimeError(f"{name}: timing implausible after {retries} "
                       f"retries ({reason})")


def _share(value, roofline) -> str:
    if roofline is None:
        return "roofline share not measured (rehearsal)"
    return (f"{value / roofline:.3f} of the gather-formulation roofline "
            f"({roofline / 1e9:.2f} Gnnz*trials/s)")


def _best3(fn, *args):
    float(fn(*args))  # warmup/compile this variant
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# Sections.  Each owns its arrays; locals die on return.


def sec_gather(rng, dtype, roofline, tree, n_trials, iters):
    import jax
    import jax.numpy as jnp
    from canopy_tpu.engine.propagate import top_event_probability

    house = jnp.zeros((0,), dtype=dtype)
    basic_p = jnp.asarray(
        rng.uniform(0.0, 0.05, (n_trials, tree.n_basic)), dtype=dtype)

    @jax.jit
    def repeat_step(p, n_iter):
        def body(i, carry):
            acc, p = carry
            p = p.at[:, :1].mul(1.0 + 1e-9)
            return (acc + top_event_probability(tree, p, house).sum(), p)
        acc, _ = jax.lax.fori_loop(0, n_iter, body,
                                   (jnp.asarray(0.0, dtype), p))
        return acc

    dt, iters = measure(
        lambda n: _best3(repeat_step, basic_p, n), iters,
        name="gather", work=tree.nnz * n_trials, roofline=roofline)
    value = tree.nnz * n_trials / dt
    _record("gather", value, "nnz*trials/s", dt, iters)
    print(f"bench[gather {tree.n_gates}g]: {dt*1e3:.2f} ms/iter, "
          f"{value/1e9:.2f} Gnnz*trials/s, {_share(value, roofline)}",
          file=sys.stderr)


def sec_config3(rng, dtype, roofline, fanin):
    """Config-3 scale: the 1M-gate synthetic on one card
    (BASELINE.md:36), with the index arrays as jit arguments
    (make_param_propagator) instead of ~30 MB of folded constants."""
    import jax
    import jax.numpy as jnp
    from canopy_tpu.engine.propagate import make_param_propagator
    from canopy_tpu.utils.synthetic import synthetic_compiled_tree

    m_gates = int(os.environ.get("BENCH_M_GATES", "1000000"))
    m_trials = int(os.environ.get("BENCH_M_TRIALS", "1024"))
    tree_m = synthetic_compiled_tree(n_basic=65536, n_gates=m_gates,
                                     fanin=fanin, n_levels=14, seed=0)
    fn_m, params_m = make_param_propagator(tree_m)
    params_m = jax.device_put(params_m)
    basic_m = jnp.asarray(
        rng.uniform(0.0, 0.05, (m_trials, tree_m.n_basic)), dtype)
    house_m = jnp.zeros((0,), dtype)

    @jax.jit
    def repeat_m(params, p, n_iter):
        def body(i, carry):
            acc, p = carry
            p = p.at[:, :1].mul(1.0 + 1e-9)
            return (acc + fn_m(params, p, house_m).sum(), p)
        acc, _ = jax.lax.fori_loop(0, n_iter, body,
                                   (jnp.asarray(0.0, dtype), p))
        return acc

    m_iters = int(os.environ.get("BENCH_M_ITERS", "8"))
    m_dt, m_iters = measure(
        lambda n: _best3(repeat_m, params_m, basic_m, n), m_iters,
        name="config3-1M-gates", work=tree_m.nnz * m_trials,
        roofline=roofline)
    m_value = tree_m.nnz * m_trials / m_dt
    _record("config3-1M-gates", m_value, "nnz*trials/s", m_dt, m_iters)
    print(f"bench[config3 {tree_m.n_gates}g 1M]: {m_dt*1e3:.2f} ms/"
          f"iter, {m_value/1e9:.2f} Gnnz*trials/s, "
          f"{_share(m_value, roofline)} (nnz={tree_m.nnz}, T={m_trials})",
          file=sys.stderr)


def sec_bf16(rng, roofline, tree, n_trials, iters, gather_value):
    """bf16-storage gather on the big uniform tree at double the trial
    width (storage halves row bytes; compute stays f32)."""
    import jax
    import jax.numpy as jnp
    from canopy_tpu.engine.propagate import top_event_probability

    bf_trials = 2 * n_trials
    basic_bf = jnp.asarray(
        rng.uniform(0.0, 0.05, (bf_trials, tree.n_basic)), jnp.bfloat16)
    house_bf = jnp.zeros((0,), jnp.bfloat16)

    @jax.jit
    def repeat_bf(p, n_iter):
        def body(i, carry):
            acc, p = carry
            # Perturbation above bf16 granularity (defeats CSE).
            p = p.at[:, :1].mul(jnp.bfloat16(1.01))
            out = top_event_probability(tree, p, house_bf)
            return (acc + out.astype(jnp.float32).sum(), p)
        acc, _ = jax.lax.fori_loop(0, n_iter, body,
                                   (jnp.asarray(0.0, jnp.float32), p))
        return acc

    bf_dt, iters = measure(
        lambda n: _best3(repeat_bf, basic_bf, n), iters,
        name="gather-bf16", work=tree.nnz * bf_trials, roofline=roofline)
    bf_value = tree.nnz * bf_trials / bf_dt
    _record("gather-bf16", bf_value, "nnz*trials/s", bf_dt, iters)
    print(f"bench[gather-bf16 {tree.n_gates}g T={bf_trials}]: "
          f"{bf_dt*1e3:.2f} ms/iter, {bf_value/1e9:.2f} "
          f"Gnnz*trials/s ({bf_value/max(gather_value,1):.2f}x f32)",
          file=sys.stderr)


def sec_mc(rng, roofline, tree, n_trials, iters, best_float):
    """Bit-packed Boolean MC engine (32 trials per uint32 word)."""
    import jax
    import jax.numpy as jnp
    from canopy_tpu.ops.bitpack import propagate_packed

    house = jnp.zeros((0,), jnp.float32)
    mc_words = max(n_trials // 32, 8)
    packed = jnp.asarray(
        rng.integers(0, 2**32, (tree.n_basic, mc_words), dtype=np.uint32))

    @jax.jit
    def repeat_packed(packed_basic, n_iter):
        def body(i, acc):
            p = packed_basic ^ i.astype(jnp.uint32)
            vals = propagate_packed(tree, p, house)
            count = jax.lax.population_count(vals[tree.top_index])
            return acc + count.sum().astype(jnp.float32)
        return jax.lax.fori_loop(0, n_iter, body,
                                 jnp.asarray(0.0, jnp.float32))

    mc_dt, iters = measure(
        lambda n: _best3(repeat_packed, packed, n), iters,
        name="mc-bitpacked", work=tree.nnz * mc_words * 32,
        roofline=roofline, cap=4 * _CAP)  # 32 trials/word
    mc_value = tree.nnz * mc_words * 32 / mc_dt
    _record("mc-bitpacked", mc_value, "nnz*trials/s", mc_dt, iters)
    print(f"bench[mc-bitpacked]: {mc_dt*1e3:.2f} ms/iter, "
          f"{mc_value/1e9:.2f} Gnnz*trials/s "
          f"({mc_value/max(best_float,1):.1f}x the float path)",
          file=sys.stderr)


def sec_bsr(rng, dtype, roofline, n_trials, iters):
    """BSR matmul log-space engine after locality reordering, on an
    adversarially shuffled hierarchical tree, vs gather."""
    import jax
    import jax.numpy as jnp
    from canopy_tpu.compiler.reorder import locality_reorder, random_shuffle
    from canopy_tpu.engine.propagate import top_event_probability
    from canopy_tpu.ops.bsr_propagate import (bsr_arrays,
                                              bsr_top_probability,
                                              compile_bsr,
                                              estimate_bsr_fill)
    from canopy_tpu.utils.synthetic import synthetic_hierarchical_tree

    house = jnp.zeros((0,), dtype=dtype)
    bsr_basics = int(os.environ.get("BENCH_BSR_BASICS", "262144"))
    branching = int(os.environ.get("BENCH_BSR_BRANCHING", "8"))
    shuffled = random_shuffle(synthetic_hierarchical_tree(
        n_basic=bsr_basics, branching=branching, share_fraction=0.1,
        n_shared=256, seed=0), seed=1).tree
    fill_shuffled = estimate_bsr_fill(shuffled)
    tree_l = locality_reorder(shuffled).tree
    program = compile_bsr(tree_l)
    bsr_params = jax.device_put(bsr_arrays(program))
    bsr_trials = min(n_trials, 512)
    basic_p_bsr = jnp.asarray(
        rng.uniform(0.0, 0.05, (bsr_trials, tree_l.n_basic)), dtype=dtype)

    @jax.jit
    def repeat_bsr(basic_p, n_iter, params):
        def body(i, carry):
            acc, p = carry
            p = p.at[:, :1].mul(1.0 + 1e-9)
            return (acc + bsr_top_probability(
                program, p, params=params).sum(), p)
        acc, _ = jax.lax.fori_loop(0, n_iter, body,
                                   (jnp.asarray(0.0, dtype), basic_p))
        return acc

    @jax.jit
    def repeat_gather_l(basic_p, n_iter):
        def body(i, carry):
            acc, p = carry
            p = p.at[:, :1].mul(1.0 + 1e-9)
            return (acc + top_event_probability(tree_l, p, house).sum(),
                    p)
        acc, _ = jax.lax.fori_loop(0, n_iter, body,
                                   (jnp.asarray(0.0, dtype), basic_p))
        return acc

    bsr_dt, bsr_used = measure(
        lambda n: _best3(repeat_bsr, basic_p_bsr, n, bsr_params), iters,
        name="bsr+reorder", work=tree_l.nnz * bsr_trials,
        roofline=roofline)
    gat_dt, gat_used = measure(
        lambda n: _best3(repeat_gather_l, basic_p_bsr, n), iters,
        name="gather-on-reordered", work=tree_l.nnz * bsr_trials,
        roofline=roofline)
    bsr_v = tree_l.nnz * bsr_trials / bsr_dt
    gat_v = tree_l.nnz * bsr_trials / gat_dt
    _record("bsr+reorder", bsr_v, "nnz*trials/s", bsr_dt, bsr_used)
    _record("gather-on-reordered", gat_v, "nnz*trials/s", gat_dt,
            gat_used)
    print(f"bench[bsr+reorder br={branching}]: {bsr_dt*1e3:.2f} ms "
          f"({bsr_v/1e9:.2f} G/s, fill {fill_shuffled:.0f}x -> "
          f"{program.fill_ratio:.0f}x) vs gather {gat_dt*1e3:.2f} ms "
          f"({gat_v/1e9:.2f} G/s) -> {gat_dt/bsr_dt:.2f}x",
          file=sys.stderr)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------


def _base_params(rehearse: bool):
    n_trials = int(os.environ.get("BENCH_TRIALS", "2048"))
    n_gates = int(os.environ.get("BENCH_GATES", "400000"))
    fanin = int(os.environ.get("BENCH_FANIN", "4"))
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    roofline = None
    if not rehearse:
        from canopy_tpu.device import peaks
        roofline = peaks().hbm_bytes_per_s / (4.0 + 8.0 / fanin)
    return n_trials, n_gates, fanin, iters, roofline


def _big_tree(n_gates, fanin):
    from canopy_tpu.utils.synthetic import synthetic_compiled_tree
    return synthetic_compiled_tree(n_basic=8192, n_gates=n_gates,
                                   fanin=fanin, n_levels=14, seed=0)


def run_sections(rehearse: bool) -> None:
    import jax
    import jax.numpy as jnp

    n_trials, n_gates, fanin, iters, roofline = _base_params(rehearse)
    dtype = jnp.float32
    tree = _big_tree(n_gates, fanin)
    plan = {
        "gather": lambda rng: sec_gather(rng, dtype, roofline, tree,
                                         n_trials, iters),
        "config3-1M": lambda rng: sec_config3(rng, dtype, roofline, fanin),
        "gather-bf16": lambda rng: sec_bf16(
            rng, roofline, tree, n_trials, iters,
            _sections.get("gather", {}).get("value", 0.0)),
        "mc-bitpacked": lambda rng: sec_mc(
            rng, roofline, tree, n_trials, iters,
            _sections.get("gather", {}).get("value", 0.0)),
        "bsr": lambda rng: sec_bsr(rng, dtype, roofline, n_trials, iters),
    }
    only = os.environ.get("BENCH_ONLY")
    only = set(only.split(",")) if only else None
    for name, run in plan.items():
        if only is not None and name not in only:
            continue
        try:
            run(np.random.default_rng(0))
        except Exception as exc:
            _failed[name] = f"{type(exc).__name__}: {exc}"
            print(f"bench[{name}] failed: {exc}", file=sys.stderr)
        finally:
            jax.clear_caches()
            gc.collect()


def main(argv: list[str]) -> int:
    import jax

    from canopy_tpu.device import backend, require_gpu, setup_compile_cache

    rehearse = "--rehearse" in argv
    cache = setup_compile_cache()
    if not rehearse:
        require_gpu()
    device = jax.devices()[0]
    roofline = _base_params(rehearse)[4]
    print(f"bench: backend={backend()} device={device.device_kind} "
          f"compile cache={cache}", file=sys.stderr)
    run_sections(rehearse)

    gather = _sections.get("gather", {}).get("value", 0.0)
    line = {
        "metric": "spmm_gate_propagation_nnz_trials_per_s",
        "value": gather,
        "unit": "nnz*trials/s",
        "device": {"platform": device.platform,
                   "kind": device.device_kind,
                   "count": len(jax.devices())},
        "sections": {k: v["value"] for k, v in _sections.items()},
    }
    if roofline is not None:
        line["vs_baseline"] = gather / roofline
    if _failed:
        line["failed"] = _failed
    print("bench-sections: " + json.dumps(_sections), file=sys.stderr)
    if _failed:
        print("bench-failed: " + json.dumps(_failed), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 1 if _failed or gather <= 0 else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
