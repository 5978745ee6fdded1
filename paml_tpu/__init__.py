"""paml_tpu: phylogenetic analysis by maximum likelihood in JAX (PAML
capabilities).

Importing the package sets two process-wide JAX options:

* float32 matrix products run at ``Precision.HIGHEST`` (true f32; on GPUs
  the default would allow TF32, which keeps about three decimal digits —
  far coarser than the likelihood needs).  float64 is unaffected.
* the persistent compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is
  set, JAX reads it and nothing here overrides it; otherwise the cache is
  ``<checkout>/.jax_cache``.  Compiling the larger likelihood programs
  takes tens of seconds; the cache lets later runs of the same model and
  data shape skip it.
"""
import os as _os

DEFAULT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _configure_jax() -> None:
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE)


_configure_jax()
