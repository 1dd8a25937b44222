"""Hot-path ops: bit-packed Boolean evaluation and BSR log-space propagation."""

from .bitpack import (pack_states, packed_top_probability,  # noqa: F401
                      propagate_packed, sample_states_packed)
