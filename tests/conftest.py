"""Test configuration: force the JAX CPU backend with 8 virtual devices.

Mirrors the multi-host-without-a-cluster strategy from SURVEY.md §4.4:
`--xla_force_host_platform_device_count=8` gives every test session a
deterministic 8-device mesh for sharding tests, with no accelerator
required. The config value is set as well as the environment variable, so
a platform chosen earlier in the process cannot win.

``CANOPY_TEST_GPU=1`` leaves the platform alone, for the tests marked
``gpu`` (``CANOPY_TEST_GPU=1 python -m pytest -m gpu tests/`` on a GPU).
"""

import os

if os.environ.get("CANOPY_TEST_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
