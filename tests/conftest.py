"""Test configuration: run the suite on a virtual 8-device CPU platform.

``JAX_PLATFORMS`` defaults to ``cpu`` here and, when it is ``cpu``, the platform is
also pinned through ``jax.config`` before any backend is initialized.  Numerics
tests get native float64 on CPU; sharding tests get an 8-device mesh.  Tests that
need a card are marked ``gpu`` and skip inside the test when JAX finds none; run
them on a GPU machine with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
