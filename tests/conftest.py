"""Test configuration: run on CPU with a virtual 8-device mesh.

Multi-chip sharding logic is validated without accelerator hardware via
XLA's host-platform device partitioning (SURVEY.md §4 test plan). Tests run
on the CPU platform unless ``JAX_PLATFORMS`` names others (the ``gpu``-
marked tests need ``JAX_PLATFORMS=cuda,cpu`` on a machine with a card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Build the native serving library so test_serve's native/numpy
# exact-match test always runs (the hermetic suite must not silently
# lose coverage of a shipped component). Fail loudly if a
# compiler is present but the build breaks; skip the build only when no
# C++ toolchain exists at all.
import shutil  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
if shutil.which("make") and shutil.which("g++"):
    subprocess.run(
        ["make", "-C", str(_NATIVE_DIR), "--quiet"],
        check=True,
        capture_output=True,
        text=True,
    )
