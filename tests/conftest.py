import os

# Tests run on CPU with a virtual 8-device mesh so multi-device sharding
# compiles and executes without accelerator hardware.  jax may already be
# imported when this file runs, so update jax.config as well as the env.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
