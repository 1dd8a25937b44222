"""canopy-tpu: an accelerated sparse linear-algebra framework for PRA.

A from-scratch rebuild of the capability set of ``openpra-org/canopy``
(see SURVEY.md): OpenPSA-MEF fault/event-tree ingestion and validation, a
compiler from the gate DAG to level-scheduled CSR structure matrices, and
JAX/XLA quantification engines — probability propagation (SpMV-like),
batched epistemic uncertainty (SpMM-like), Monte-Carlo state sampling,
importance via autodiff, cut-set generation and approximations — scaling
over `jax.sharding` meshes.
"""

__version__ = "0.3.0"

def build_info() -> dict:
    """Git-derived build metadata (commit, count, dirty) — the
    reference's ``cmake/build-info.cmake`` analogue; see
    :mod:`canopy_tpu.build_info`."""
    from .build_info import build_info as _bi
    return _bi()

# Risk quantification routinely works with probabilities at the 1e-9..1e-2
# scale and 1e-8 cut-offs; float64 is the correctness default. Performance
# paths (sampling, bench) opt into f32/bf16 with explicit dtypes.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .settings import Algorithm, Approximation, Settings  # noqa: F401,E402
from . import errors  # noqa: F401,E402
