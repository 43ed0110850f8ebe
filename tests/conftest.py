"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run on the host platform (JAX_PLATFORMS=cpu unless the caller set
another platform), with 8 virtual CPU devices so multi-device layouts are
exercised without GPUs.  The platform is also set through jax.config,
which takes precedence over the environment should anything have
configured JAX before this file.  Tests marked `gpu` decide inside the
test whether a card is present and skip elsewhere; on a GPU machine run
them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
