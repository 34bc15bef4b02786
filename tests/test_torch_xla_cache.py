"""One XLA compilation cache for a whole test session, shared by its workers.

The port's tests hold it to the JAX package, so their modules compile the
JAX package's programs (the scan pipeline's chunk step, the multi-scene
runner, ...) at the same shapes as other modules do, the JAX package's own
tests among them: in each of pytest-xdist's worker processes, and again
after every module, since tests/conftest.py drops a process's compiled
executables between modules.  This module points JAX's persistent
compilation cache at one directory under the temporary directory, so that
a program that took a second or more to compile is compiled once and then
loaded by every later module and worker.  A loaded executable is the one
the compiler made: no result changes.

pytest-xdist imports every test module in every worker while it collects,
before any test runs, so the cache holds for the whole session in each
worker.  Run alone, this module configures only its own process.
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
from jax.experimental.compilation_cache import compilation_cache

CACHE_DIR = Path(tempfile.gettempdir()) / "sfm_tpu_tests_xla_cache"

compilation_cache.set_cache_dir(str(CACHE_DIR))
# a program compiled while the session collected (before this module was
# imported) has fixed the cache as unused: look again at the next compile
compilation_cache.reset_cache()


def _probe(x):
    return jnp.cumsum(x * 3.0 + 0.125)[::-1] - 7.0


def test_xla_compilations_go_through_the_shared_cache():
    """A program compiled in this session has its entry in the shared
    directory, and the executable loaded back gives the same result."""
    min_s = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        x = jnp.arange(4099, dtype=jnp.float32)
        y = jax.jit(_probe)(x)
        assert jax.config.jax_compilation_cache_dir == str(CACHE_DIR)
        assert list(CACHE_DIR.glob("jit__probe-*")), \
            "no entry in the shared cache"
        jax.clear_caches()
        assert (jax.jit(_probe)(x) == y).all()
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
