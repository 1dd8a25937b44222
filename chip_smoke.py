#!/usr/bin/env python
"""Smoke test of the MEF -> report path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-3 + GPU tests
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Runs everything in this one process (a second JAX process would find the
card's memory reserved) and checks every result against the repository's
own references: the frozen golden values, hand-derived closed forms,
bit-packed Monte Carlo, central finite differences and the float64 gather
engine.  Phases:

1. every MEF anchor of ``tests/fixtures/golden.json`` (plus the station
   blackout model) through ``Initializer -> RiskAnalysis -> report``, with
   the report written as XML and as JSON;
2. a generated plant model (>= 10,000 gates, CCF groups, lognormal
   deviates) through ``python -m canopy_tpu``'s ``main``, checked against
   >= 1e7-trial bit-packed Monte Carlo and finite-difference Birnbaum
   importances;
3. ``make_propagator`` on the 400k-gate bench tree in float32 and float64,
   and the 9,363-gate plant tree against its frozen value;
4. the tests marked ``gpu``.

With ``--four-cards``: the sharded uncertainty step, the sharded cut-set
quantifier, the partitioned and the pipelined propagators on the 400k-gate
tree, each against the one-card gather engine, with their outputs checked
to span four devices.

Prints the card's name and power limit, the JAX version and the compile
cache, then per phase its wall time, the peak device memory and the
largest error against its reference.  The last stdout line is one JSON
object; the exit code is non-zero if any phase failed or no GPU was found.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Runs named phases, timing each and recording its failures."""

    def __init__(self):
        self.failed: list[str] = []

    def run(self, name: str, fn) -> None:
        import jax
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            max_err = fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            log(f"-- phase {name}: FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            return
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0) / 2**30
        log(f"-- phase {name}: ok, wall {time.perf_counter() - t0:.1f} s, "
            f"peak device memory so far {peak:.2f} GiB, "
            f"max error vs reference {max_err:.3e}")


def check(name: str, got: float, want: float, rtol: float,
          atol: float = 0.0) -> float:
    """Relative error of ``got`` against ``want``; raises beyond tolerance."""
    err = abs(got - want)
    rel = err / abs(want) if want else err
    ok = err <= atol + rtol * abs(want)
    log(f"   {name}: got {got!r} want {want!r} rel err {rel:.3e}"
        f"{'' if ok else '  <-- FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {got} vs {want} "
                             f"(rtol {rtol}, atol {atol})")
    return rel


def timed(fn, *args, repeat: int = 5):
    """(result, compile+first-call seconds, median warm seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, sorted(times)[len(times) // 2]


# -- phase 1 -----------------------------------------------------------------

def analyse(paths: list[str], flags: list[str], out_dir: str, tag: str):
    """Initializer -> RiskAnalysis -> XML + JSON reports (the CLI's path)."""
    import xml.etree.ElementTree as ET

    from canopy_tpu.cli import build_parser, settings_from_args
    from canopy_tpu.engine.analysis import RiskAnalysis
    from canopy_tpu.mef.initializer import Initializer
    from canopy_tpu.report import report_to_xml

    args = build_parser().parse_args(paths + flags)
    settings = settings_from_args(args)
    t0 = time.perf_counter()
    init = Initializer(paths, settings)
    t_parse = time.perf_counter() - t0
    report = RiskAnalysis(init.model, settings).run()
    xml_path = os.path.join(out_dir, f"{tag}.xml")
    with open(xml_path, "wb") as fh:
        fh.write(report_to_xml(report))
    json_path = os.path.join(out_dir, f"{tag}.json")
    with open(json_path, "w") as fh:
        fh.write(report.to_json(indent=1))
    # Both writers round-trip the same numbers.
    doc = ET.parse(xml_path).getroot()
    payload = json.load(open(json_path))
    for ft, el in zip(payload["fault_trees"],
                      doc.findall("results/fault-tree-analysis")):
        if "probability" in ft:
            assert float(el.find("probability").get("value")) \
                == ft["probability"], tag
    host = sum(v for k, v in report.timings.items()
               if k.split(":")[0] in ("compile", "bdd", "products"))
    log(f"   {tag}: parse {t_parse:.2f} s, host compile/BDD {host:.2f} s, "
        f"total analysis {report.timings['total']:.2f} s")
    return report, payload


def phase_golden(out_dir: str) -> float:
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_station_blackout import expected_ep_failed

    golden = json.load(open(os.path.join(FIXTURES, "golden.json")))
    worst = 0.0
    full = ["--bdd", "--ccf", "--probability", "--importance",
            "--uncertainty", "--num-trials", "2000"]
    for name, entry in sorted(golden.items()):
        kind = entry.get("kind", "fault_tree")
        path = os.path.join(FIXTURES, f"{name}.xml")
        if kind == "fault_tree":
            if entry.get("bdd_max_nodes", 0) > 2_000_000:
                log(f"   {name}: skipped here (its exact BDD needs a "
                    f"{entry['bdd_max_nodes']:,}-node build on the host; "
                    f"the CPU tests cover it)")
                continue
            _r, payload = analyse([path], full, out_dir, name)
            ft = payload["fault_trees"][0]
            worst = max(worst, check(f"{name} P(top)", ft["probability"],
                                     entry["exact_probability"], 1e-9))
            mif = np.array([row["MIF"] for row in ft["importance"]])
            assert len(mif) and np.isfinite(mif).all(), name
            unc = ft.get("uncertainty")      # Only models with deviates.
            assert unc is None or (0.0 <= unc["mean"] <= 1.0
                                   and unc["n_trials"] == 2000), name
        elif kind == "substitution":
            _r, payload = analyse([path], ["--probability"], out_dir, name)
            ft = payload["fault_trees"][0]
            worst = max(worst, check(f"{name} P(top)", ft["probability"],
                                     entry["exact_probability"], 1e-9))
            assert ft["n_products"] == \
                entry["n_products_after_substitution"], name
        elif kind == "alignment":
            _r, payload = analyse([path], ["--probability"], out_dir, name)
            phases = {ft["phase"]: ft["probability"]
                      for ft in payload["fault_trees"]
                      if ft.get("alignment") == "duty"}
            for phase, want in entry["phases"].items():
                worst = max(worst, check(f"{name} {phase}", phases[phase],
                                         want, 1e-9))
        elif kind == "event_tree":
            _r, payload = analyse([path], ["--probability", "--uncertainty",
                                           "--num-trials", "2000"],
                                  out_dir, name)
            seqs = {s["sequence"]: s for s in payload["sequences"]}
            for seq, want in entry["sequences"].items():
                worst = max(worst, check(f"{name} {seq}",
                                         seqs[seq]["probability"], want,
                                         1e-9))
        else:
            log(f"   {name}: {kind} anchor, evaluated in phase 3")
    path = os.path.join(FIXTURES, "station_blackout.xml")
    _r, payload = analyse([path], full, out_dir, "station_blackout")
    p_fail = expected_ep_failed()
    base = [ft for ft in payload["fault_trees"] if "alignment" not in ft][0]
    worst = max(worst, check("station_blackout P(top)", base["probability"],
                             p_fail, 1e-9))
    seqs = {s["sequence"]: s["probability"] for s in payload["sequences"]}
    for seq, want in (("SafeShutdown", 1 - p_fail),
                      ("RecoveredLate", 0.9 * p_fail),
                      ("Blackout", 0.1 * p_fail)):
        worst = max(worst, check(f"station_blackout {seq}", seqs[seq],
                                 want, 1e-9))
    return worst


# -- phase 2 -----------------------------------------------------------------

def phase_plant(out_dir: str) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from canopy_tpu.cli import main as cli_main
    from canopy_tpu.compiler.graph import compile_fault_tree
    from canopy_tpu.compiler.modules import (build_modular_bdd,
                                             modular_probability)
    from canopy_tpu.engine.propagate import mean_basic_probabilities
    from canopy_tpu.io.mef_writer import model_to_mef_xml
    from canopy_tpu.mef.initializer import Initializer
    from canopy_tpu.settings import Settings
    from canopy_tpu.utils.synthetic import synthetic_plant_model

    t0 = time.perf_counter()
    model = synthetic_plant_model(seed=0)
    xml_path = os.path.join(out_dir, "plant.xml")
    with open(xml_path, "wb") as fh:
        fh.write(model_to_mef_xml(model))
    log(f"   plant model: {len(model.gates)} gates, "
        f"{len(model.basic_events)} basic events, "
        f"{len(model.ccf_groups)} CCF groups; generated and written in "
        f"{time.perf_counter() - t0:.1f} s")

    # Independent references, built from the same XML.
    t0 = time.perf_counter()
    settings = Settings().probability_analysis(True).ccf_analysis(True)
    ref_model = Initializer([xml_path], settings).model
    tree = compile_fault_tree(ref_model.fault_trees.get("plant"))
    modular = build_modular_bdd(tree)
    log(f"   reference build (parse, compile, modular BDD): "
        f"{time.perf_counter() - t0:.1f} s; {tree.n_gates} gates after CCF "
        f"expansion, {len(modular.chain)} modules, "
        f"{modular.total_nodes} BDD nodes, "
        f"{len(modular.fused().levels)} fused levels")

    # Batch size: a quarter of the card's memory for the trial-major
    # sample and the node-major value matrix of one uncertainty batch.
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit",
                                                        16 * 2**30)
    rows = modular.fused().n_rows + 2 * tree.n_basic
    batch = int(min(100_000, 0.25 * limit / (8 * rows)) // 1000 * 1000)
    report_path = os.path.join(out_dir, "plant_report.json")
    argv = [xml_path, "--platform", "gpu", "--bdd", "--ccf",
            "--skip-products", "--probability", "--importance",
            "--uncertainty", "--num-trials", "100000", "--batch-size",
            str(batch), "-o", report_path]
    log(f"   python -m canopy_tpu {' '.join(argv)}")
    t0 = time.perf_counter()
    code = cli_main(argv)
    wall = time.perf_counter() - t0
    assert code == 0, f"CLI exit code {code}"
    report = json.load(open(report_path))
    ft = report["fault_trees"][0]
    timings = report["timings"]
    host = sum(v for k, v in timings.items()
               if k.split(":")[0] in ("compile", "bdd"))
    device = sum(v for k, v in timings.items()
                 if k.split(":")[0] in ("probability", "importance",
                                        "uncertainty"))
    log(f"   CLI wall {wall:.1f} s: parse+write {wall - timings['total']:.1f}"
        f" s, host compile/BDD {host:.1f} s, device phases (jit compile "
        f"included) {device:.1f} s: " + ", ".join(
            f"{k.split(':')[0]} {v:.2f} s" for k, v in timings.items()
            if k != "total"))
    p_top = ft["probability"]
    assert ft["method"] == "bdd/direct-propagation", ft["method"]

    # (a) BDD probability against >= 1e7 trials of bit-packed MC, 4 sigma,
    # through the CLI's Monte Carlo approximation.
    mean_p = jnp.asarray(mean_basic_probabilities(tree))
    n_mc = 10_000_000
    mc_path = os.path.join(out_dir, "plant_mc.json")
    t0 = time.perf_counter()
    code = cli_main([xml_path, "--platform", "gpu", "--ccf",
                     "--skip-products", "--probability", "--monte-carlo",
                     "--num-trials", str(n_mc), "-o", mc_path])
    assert code == 0, f"CLI exit code {code}"
    mc_ft = json.load(open(mc_path))["fault_trees"][0]
    estimate = mc_ft["probability"]
    assert mc_ft["method"].endswith("monte_carlo"), mc_ft["method"]
    sigma = math.sqrt(p_top * (1 - p_top) / n_mc)
    log(f"   bit-packed MC (--monte-carlo): {n_mc} trials, CLI wall "
        f"{time.perf_counter() - t0:.1f} s (parse and compile included): "
        f"{estimate!r} vs BDD {p_top!r}, "
        f"{abs(estimate - p_top) / sigma:.2f} sigma")
    assert abs(estimate - p_top) <= 4 * sigma, "MC outside 4 sigma"
    worst = abs(estimate - p_top) / p_top

    # (b) Birnbaum importance against central finite differences.
    top = jax.jit(lambda p: modular_probability(modular, p))
    worst = max(worst, check("plant P(top) vs modular reference", p_top,
                             float(top(mean_p)), 1e-12))
    table = {row["event"]: row for row in ft["importance"]}
    names = sorted(table, key=lambda e: -table[e]["MIF"])
    relevant = [e for e in names[3:]
                if table[e]["MIF"] > 1e-6 * table[names[0]]["MIF"]]
    rng = np.random.default_rng(0)
    picks = names[:3] + list(rng.choice(relevant, 2, replace=False))
    for event in picks:
        slot = tree.basic_index[event]
        p_i = float(mean_p[slot])
        h = 0.5 * min(p_i, 1.0 - p_i)
        fd = (float(top(mean_p.at[slot].set(p_i + h)))
              - float(top(mean_p.at[slot].set(p_i - h)))) / (2 * h)
        check(f"MIF[{event}] vs finite difference", table[event]["MIF"], fd,
              1e-6, atol=1e-9)
    unc = ft["uncertainty"]
    log(f"   uncertainty: {unc['n_trials']} trials, mean {unc['mean']:.6e}, "
        f"EF {unc['error_factor']:.3f}, batch {batch}")
    assert unc["n_trials"] == 100_000
    # The top probability is multilinear in independently sampled event
    # probabilities, so its mean under uncertainty is P(top) at the means
    # up to sampling error (CCF members share one sample: a small bias).
    check("uncertainty mean vs P(top)", unc["mean"], p_top,
          0.02, atol=5 * unc["std"] / math.sqrt(unc["n_trials"]))
    return worst


# -- phase 3 -----------------------------------------------------------------

def phase_propagation() -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from canopy_tpu.compiler.graph import prune_to_top_cone
    from canopy_tpu.compiler.modules import (build_modular_bdd,
                                             modular_probability)
    from canopy_tpu.device import peaks
    from canopy_tpu.engine.propagate import make_propagator
    from canopy_tpu.utils.synthetic import (synthetic_compiled_tree,
                                            synthetic_hierarchical_tree)

    bandwidth = peaks().hbm_bytes_per_s
    tree = synthetic_compiled_tree(n_basic=8192, n_gates=400_000, fanin=4,
                                   n_levels=14, seed=0)
    cone = prune_to_top_cone(tree)
    log(f"   400k tree: {tree.n_gates} gates, nnz {tree.nnz}; top cone "
        f"{cone.n_gates} gates, nnz {cone.nnz}")
    fn = make_propagator(tree)
    rng = np.random.default_rng(0)
    worst = 0.0
    for n_trials in (2048, 16384):
        p64 = jnp.asarray(rng.uniform(0.0, 0.05, (n_trials, tree.n_basic)))
        results = {}
        for dtype in (jnp.float64, jnp.float32):
            p = p64.astype(dtype)
            out, first, warm = timed(fn, p)
            results[dtype] = np.asarray(out, np.float64)
            nbytes = (cone.nnz + cone.n_gates) * n_trials \
                * jnp.dtype(dtype).itemsize
            log(f"   gather T={n_trials} {jnp.dtype(dtype).name}: "
                f"compile+first {first:.2f} s, warm {warm * 1e3:.3f} ms, "
                f"{nbytes / warm / 1e9:.1f} GB/s = "
                f"{nbytes / warm / bandwidth:.3f} of peak memory bandwidth")
        ref = results[jnp.float64]
        err = np.max(np.abs(results[jnp.float32] - ref) / np.abs(ref))
        log(f"   T={n_trials}: max rel error float32 vs float64 {err:.3e}")
        assert err <= 1e-5, err
        worst = max(worst, err)
        del p64

    # Importance by jax.grad through the gather engine (one point).
    grad = jax.jit(jax.grad(lambda p: fn(p[None, :])[0]))
    p_point = jnp.asarray(rng.uniform(0.0, 0.05, tree.n_basic))
    g, first, warm = timed(grad, p_point)
    assert np.isfinite(np.asarray(g)).all()
    log(f"   jax.grad through the gather engine (400k tree, one point): "
        f"compile+first {first:.2f} s, warm {warm * 1e3:.3f} ms")

    golden = json.load(open(os.path.join(FIXTURES, "golden.json")))
    entry = golden["plant_hier_9363"]
    plant = synthetic_hierarchical_tree(**entry["generator"])
    p = jnp.asarray(np.random.default_rng(42).uniform(1e-4, 5e-3,
                                                      plant.n_basic))
    modular = build_modular_bdd(plant, max_nodes=50_000_000)
    exact = float(jax.jit(lambda q: modular_probability(modular, q))(p))
    worst = max(worst, check("plant_hier_9363 modular BDD", exact,
                             entry["exact_probability"], 1e-9))
    direct = float(make_propagator(plant)(p))
    log(f"   plant_hier_9363 make_propagator (independence approximation "
        f"on {entry['generator']['n_shared']} shared events): {direct!r}, "
        f"{abs(direct - exact) / exact:.3e} from exact")
    assert abs(direct - exact) < 0.05
    batch = jnp.broadcast_to(p, (4096, plant.n_basic))
    _out, first, warm = timed(jax.jit(
        lambda q: modular_probability(modular, q)), batch)
    log(f"   plant_hier_9363 modular BDD, 4096 trials: compile+first "
        f"{first:.2f} s, warm {warm * 1e3:.3f} ms")
    from canopy_tpu.ops.bitpack import packed_top_probability
    t0 = time.perf_counter()
    mc = float(packed_top_probability(plant, jax.random.PRNGKey(7), p,
                                      10_002_432))
    sigma = math.sqrt(exact * (1 - exact) / 10_002_432)
    log(f"   plant_hier_9363 bit-packed MC, 10002432 trials: {mc!r} "
        f"({abs(mc - exact) / sigma:.2f} sigma from exact) in "
        f"{time.perf_counter() - t0:.1f} s")
    assert abs(mc - exact) <= 4 * sigma
    return worst


# -- phase 4 -----------------------------------------------------------------

def phase_gpu_tests() -> float:
    import pytest
    os.environ["CANOPY_TEST_GPU"] = "1"
    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        os.path.join(ROOT, "tests", "test_gpu.py")])
    assert code == 0, f"pytest -m gpu exit code {code}"
    return 0.0


def phase_four_cards(n_gates: int = 400_000, n_basic: int = 8192,
                     n_products: int = 65_536) -> float:
    import re

    import jax
    import jax.numpy as jnp
    import numpy as np

    from canopy_tpu.engine.cutset_quantify import (build_cutset_matrix, mcub,
                                                   product_probabilities,
                                                   rare_event)
    from canopy_tpu.engine.propagate import make_propagator
    from canopy_tpu.parallel.mesh import make_mesh
    from canopy_tpu.parallel.partition import make_partitioned_propagator
    from canopy_tpu.parallel.pipeline import (make_pipe_mesh,
                                              make_pipeline_propagator)
    from canopy_tpu.parallel.quantify import (sharded_cutset_quantifier,
                                              sharded_uncertainty_step)
    from canopy_tpu.utils.synthetic import synthetic_compiled_tree

    devices = jax.devices()
    assert len(devices) == 4, f"need 4 devices, found {len(devices)}"

    def spans_four(name, array):
        used = {s.device for s in array.addressable_shards}
        assert len(array.sharding.device_set) == 4 and len(used) == 4, \
            f"{name}: lives on {len(used)} device(s)"
        log(f"   {name}: output shards on {len(used)} devices, sharding "
            f"{array.sharding}")

    def splits_work(name, fn, args, collective, expected):
        """The compiled SPMD program: four partitions, and the collective
        that joins the parts each device computed (``expected`` of them
        in the program as written)."""
        t0 = time.perf_counter()
        hlo = fn.lower(*args).compile().as_text()
        assert "num_partitions=4" in hlo, f"{name}: not a 4-way program"
        found = re.findall(rf"\b{collective}(?:-start)?\(", hlo)
        assert found, f"{name}: no {collective} in the compiled program"
        log(f"   {name}: compiled in {time.perf_counter() - t0:.2f} s for 4 "
            f"partitions with {len(found)} {collective} ops ({expected} in "
            f"the program as written)")

    def first_call(fn, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    tree = synthetic_compiled_tree(n_basic=n_basic, n_gates=n_gates,
                                   fanin=4, n_levels=14, seed=0)
    rng = np.random.default_rng(0)
    # A narrow batch, for correctness only (no times are reported): on
    # the card XLA's compile time for the 400k tree grows with the trial
    # width, and every path here compiles once.
    n_trials = 64
    basic = jnp.asarray(rng.uniform(0.0, 0.05, (n_trials, tree.n_basic)))
    house = jnp.zeros((0,))
    ref = np.asarray(make_propagator(tree)(basic))
    worst = 0.0

    def compare(name, got, rtol):
        nonlocal worst
        err = float(np.max(np.abs(np.asarray(got) - ref) / np.abs(ref)))
        log(f"   {name}: max rel error vs one-card gather {err:.3e}")
        assert err <= rtol, (name, err)
        worst = max(worst, err)

    mesh = make_mesh(devices)
    log(f"   mesh {dict(mesh.shape)}")
    step = sharded_uncertainty_step(tree, mesh)
    out, first = first_call(step, basic, house)
    spans_four("sharded_uncertainty_step", out)
    log(f"   sharded_uncertainty_step: compile+first {first:.2f} s")
    compare("sharded_uncertainty_step", out, 1e-12)

    # Partitioned (gate rows over "model", one all-gather of the new rows
    # per level block) and pipelined (levels over "pipe", the value block
    # passed round the ring) propagation.  Their outputs are replicated
    # by design, so the split shows in the compiled program.
    n_blocks = sum(1 for level in tree.levels
                   for _kind, block in level.iter_blocks() if block.n_gates)
    mesh_tp = make_mesh(devices, model_parallelism=4)
    part = make_partitioned_propagator(tree, mesh_tp)
    splits_work("make_partitioned_propagator", part, (basic, house),
                "all-gather", n_blocks)
    out, first = first_call(part, basic, house)
    log(f"   make_partitioned_propagator (model=4): first call {first:.2f} s")
    compare("make_partitioned_propagator", out, 1e-12)
    pipe = make_pipeline_propagator(tree, make_pipe_mesh(devices, pipe=4))
    splits_work("make_pipeline_propagator", pipe, (basic, house),
                "collective-permute", 1)
    out, first = first_call(pipe, basic, house)
    log(f"   make_pipeline_propagator (pipe=4): first call {first:.2f} s")
    compare("make_pipeline_propagator", out, 1e-12)

    # Cut-set quantifier: product rows over "model", trials over "data".
    # The products are random (the quantifier's arithmetic does not care
    # how they were derived; no cut-set algorithm reaches a 400k tree).
    slots = rng.integers(0, tree.n_basic, (n_products, 4))
    orders = rng.integers(1, 5, n_products)
    matrix = build_cutset_matrix(
        [frozenset((int(s), False) for s in row[:k])
         for row, k in zip(slots, orders)], tree.n_basic)
    quantify = sharded_cutset_quantifier(matrix, mesh)
    (re_vals, mcub_vals), first = first_call(quantify, basic)
    spans_four("sharded_cutset_quantifier rare-event", re_vals)
    q = product_probabilities(matrix, basic)
    for name, got, want in (("rare-event", re_vals, rare_event(q)),
                            ("MCUB", mcub_vals, mcub(q))):
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                           / np.asarray(want)))
        log(f"   sharded_cutset_quantifier {name}: max rel error vs one "
            f"card {err:.3e} (compile+first {first:.2f} s)")
        assert err <= 1e-9, (name, err)
        worst = max(worst, err)
    return worst


# -- main --------------------------------------------------------------------

def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four GPUs")
    parser.add_argument("--out", default=None,
                        help="directory for models and reports "
                             "(default: a temporary directory)")
    args = parser.parse_args(argv)

    import jax

    from canopy_tpu.device import require_gpu, setup_compile_cache
    require_gpu()
    cache = setup_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    from canopy_tpu.native import native_available
    log(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
        f"{cache}; native BDD library "
        f"{'loaded' if native_available() else 'NOT loaded (pure Python)'}")

    phases = Phases()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        if args.four_cards:
            phases.run("four-cards", phase_four_cards)
        else:
            phases.run("golden", lambda: phase_golden(out_dir))
            phases.run("plant", lambda: phase_plant(out_dir))
            phases.run("propagation", phase_propagation)
            phases.run("gpu-tests", phase_gpu_tests)
    if phases.failed:
        log(f"FAILED phases: {', '.join(phases.failed)}")
        return 1
    device = jax.devices()[0]
    log(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
