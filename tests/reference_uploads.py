"""The JAX engine's host uploads, made race-free for two-engine tests.

On the CPU, ``jnp.asarray`` of a numpy array copies it into the device
buffer asynchronously: the copy may run after the call returns.  The
reference engine uploads its page tables (``EngineCore._page_tables_np``,
``vgate_tpu/runtime/engine_core.py`` ``_build_decode_state`` and
``_refresh_page_tables``) and rewrites the same buffer in place on later
ticks, so a copy that runs late reads rows of another tick, and the
reference's greedy stream can depend on thread timing: under load two
identical runs of it differ.  Inside ``private_uploads`` every numpy
array handed to ``jnp.asarray`` is copied first, so each upload reads a
buffer nothing changes.  The port is untouched: on the CPU it reads its
host arrays synchronously.
"""

import contextlib
from unittest import mock

import numpy as np

import jax.numpy as jnp

_ASARRAY = jnp.asarray


def _asarray(a, *args, **kwargs):
    if isinstance(a, np.ndarray):
        a = a.copy()
    return _ASARRAY(a, *args, **kwargs)


@contextlib.contextmanager
def private_uploads():
    """``jnp.asarray`` takes a private copy of each numpy input."""
    with mock.patch.object(jnp, "asarray", _asarray):
        yield
