"""Session helpers of the port's tests: a costly reference built once per
pytest session however many xdist workers run the tests that use it
(``once``), and memory handed back after each module (``release_memory``).

Under ``--dist load`` the tests of one module land on several workers, and
each worker builds the module's fixtures again.  ``once`` keeps the first
build: the worker that gets the lock builds the value and pickles it under
the session's shared temporary directory; a worker that comes later waits
on the lock and loads the file.  Without xdist (one process) it builds.
The value must pickle: numpy arrays, tensors, dicts, named tuples.

The whole suite's workers share the host's memory with the JAX package's
largest tests (one compiles a production-shape mesh step in about 30 GB),
and a worker keeps what it once held: JAX's compiled programs and freed
heap pages.  Each port module imports ``release_memory``, an autouse
fixture that, after the module's tests, collects garbage, drops JAX's
compilation caches and returns free heap pages to the system; that halves
the port's resident memory per worker (13.4 to 6.7 GB over 6 workers).
Dropping JAX's caches is a part of it: without that step the six workers'
summed peak in the port's own run (``tests/test_torch_*.py``, 6 workers,
an 8-core host) was 11.7 GB against 9.7-10.2 GB with it, at the same CPU
time; a later test compiles again what it needs.
"""

from __future__ import annotations

import ctypes
import gc
import os
import pickle
import sys

import pytest
from filelock import FileLock


def once(tmp_path_factory, name: str, build):
    """``build()``, computed once per session and shared by the workers."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return build()
    path = tmp_path_factory.getbasetemp().parent / f"torch_once_{name}.pkl"
    with FileLock(f"{path}.lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = build()
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        tmp.replace(path)
        return value


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    """After the module's tests: garbage collected, JAX's caches cleared
    (a later test compiles again what it needs), free heap pages returned
    with glibc's ``malloc_trim``."""
    yield
    gc.collect()
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
        gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):          # not glibc: nothing to trim
        pass
