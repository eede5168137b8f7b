"""Import hygiene: ``import tinyknn_tpu`` must not touch any device.

A module-level ``jnp.float32(...)`` constant once initialized the JAX
backend at import time, which turned any device failure into an
ImportError for every script. Run in a subprocess so this session's
already-initialized backend can't mask a regression.
"""

import subprocess
import sys

_PROG = """
import jax
jax.config.update("jax_platforms", "cpu")
import tinyknn_tpu  # noqa: F401
# check the backend table BEFORE live_arrays(): live_arrays itself
# initializes a backend, which would mask the real signal
backends = jax._src.xla_bridge._backends
assert not backends, f"import initialized backend(s): {list(backends)}"
n = len(jax.live_arrays())
assert n == 0, f"import created {n} device array(s)"
print("clean")
"""


def test_import_touches_no_device():
    r = subprocess.run([sys.executable, "-c", _PROG],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
