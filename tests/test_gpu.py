"""Checks that mean something only on an NVIDIA GPU.

Marked ``gpu``; they skip elsewhere. Run them on the card with
``CANOPY_TEST_GPU=1 python -m pytest -m gpu tests/`` (``chip_smoke.py``
runs them in its own process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from canopy_tpu.engine.propagate import make_propagator, top_event_probability
from canopy_tpu.utils.synthetic import (synthetic_compiled_tree,
                                        synthetic_hierarchical_tree)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


def test_float32_gather_tracks_float64(gpu):
    tree = synthetic_compiled_tree(n_basic=2048, n_gates=40_000, fanin=4,
                                   n_levels=12, seed=3)
    p = np.random.default_rng(0).uniform(0.0, 0.05, (1024, tree.n_basic))
    fn = make_propagator(tree)
    f64 = np.asarray(fn(jnp.asarray(p)))
    f32 = np.asarray(fn(jnp.asarray(p, jnp.float32)), np.float64)
    assert fn(jnp.asarray(p)).devices() == {gpu}
    np.testing.assert_allclose(f32, f64, rtol=1e-5)


def test_bsr_matmul_is_not_tf32(gpu):
    """The BSR engine's float32 einsum asks for HIGHEST precision; in
    TF32 (about three decimal digits) the log-space sums would drift far
    beyond this tolerance."""
    from canopy_tpu.compiler.reorder import locality_reorder
    from canopy_tpu.ops.bsr_propagate import compile_bsr, bsr_top_probability
    tree = locality_reorder(synthetic_hierarchical_tree(
        n_basic=4096, branching=8, share_fraction=0.0, seed=0)).tree
    program = compile_bsr(tree)
    p = np.random.default_rng(1).uniform(0.0, 0.05, (256, tree.n_basic))
    got = np.asarray(bsr_top_probability(program, jnp.asarray(p, jnp.float32)),
                     np.float64)
    want = np.asarray(top_event_probability(tree, jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_modular_grad_matches_finite_differences(gpu):
    from canopy_tpu.compiler.modules import (build_modular_bdd,
                                             modular_probability)
    tree = synthetic_hierarchical_tree(n_basic=4096, branching=8,
                                       share_fraction=0.04, n_shared=16,
                                       seed=0)
    modular = build_modular_bdd(tree)
    p = jnp.asarray(np.random.default_rng(2).uniform(1e-3, 0.1,
                                                     tree.n_basic))
    top = jax.jit(lambda q: modular_probability(modular, q))
    grad = np.asarray(jax.jit(jax.grad(top))(p))
    for i in (0, 7, 100, 4095):
        h = 0.5 * float(p[i])
        fd = (float(top(p.at[i].add(h))) - float(top(p.at[i].add(-h)))) \
            / (2 * h)
        assert abs(grad[i] - fd) <= 1e-9 + 1e-6 * abs(fd)
