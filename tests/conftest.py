import os

# Tests run on the CPU: on 8 virtual CPU devices (for the sharding tests),
# with float64 enabled.  JAX_PLATFORMS=cpu selects the CPU backend; the
# config update below does the same where the environment names another
# platform.  The persistent compilation cache is off, so the suite writes
# no CPU executables into <checkout>/.jax_cache (a cache that is copied
# to other machines, whose CPUs may differ).
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

REF = "/root/reference"


def ref_path(*parts):
    return os.path.join(REF, *parts)
