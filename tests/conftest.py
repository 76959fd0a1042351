"""Test harness configuration.

Runs the whole suite on the CPU with 8 virtual XLA devices, so the
multi-device sharding paths are exercised without accelerators (SURVEY.md
§4: the reference's analogous trick is `mpirun -np N` on one laptop).
XLA_FLAGS is read at first backend initialization, so setting it here
works; the platform is pinned through jax.config.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# f64 available for precision-sensitive parity tests; all production code
# paths set dtypes explicitly so this does not change f32 behavior.
jax.config.update("jax_enable_x64", True)
# Tests compile from scratch: no persistent compilation cache, even where
# an entry point (cli.main) points JAX at one.
jax.config.update("jax_enable_compilation_cache", False)

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8
