"""Test configuration: run everything on a virtual 8-device CPU mesh.

Kernels are written device-agnostically (pure XLA + optional Pallas with
interpret fallback); tests must not require TPU hardware. The 8 virtual CPU
devices let sharding/pjit tests validate the multi-chip layout.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache makes repeat test runs fast on this 1-core host.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

# A site plugin may force jax_platforms to the TPU; pin tests to CPU
# explicitly (env var alone is overridden by the plugin's config.update).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import warnings  # noqa: E402

# CPU can't alias the donated serving buffers (int16 coef batches); the
# donation targets TPU — the warning is expected noise here.
warnings.filterwarnings(
    "ignore", message="Some donated buffers were not usable")


def pytest_configure(config):
    # tests that need a CUDA card decide so inside the test and skip here
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (lilliput_tpu_torch kernels); "
        "skips without one")
