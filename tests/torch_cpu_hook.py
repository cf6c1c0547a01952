"""A pytest plugin that records each test's CPU seconds, for the port's
Tier-1 CPU budget (ROADMAP): user + system time of the worker and of the
children it waited for, around the test's whole protocol (setup, call,
teardown), and its wall seconds.  Not loaded unless asked for:

    CPU_HOOK_OUT=/tmp/cpu.jsonl python -m pytest tests/test_torch_*.py \\
        -p tests.torch_cpu_hook [the port-only run's flags]

writes one JSON line per test, ``{"id", "cpu", "wall", "start"}`` (start on
the host's clock, seconds since the epoch), to
``$CPU_HOOK_OUT.<xdist worker or main>``.  A module-scoped fixture counts
in the first test of its module that a worker runs.
"""

from __future__ import annotations

import json
import os
import resource
import time

import pytest


def _cpu() -> float:
    own = resource.getrusage(resource.RUSAGE_SELF)
    children = resource.getrusage(resource.RUSAGE_CHILDREN)
    return own.ru_utime + own.ru_stime + children.ru_utime + children.ru_stime


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    cpu, wall = _cpu(), time.time()
    yield
    out = os.environ.get("CPU_HOOK_OUT")
    if out:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(f"{out}.{worker}", "a") as f:
            f.write(json.dumps({"id": item.nodeid, "cpu": _cpu() - cpu,
                                "wall": time.time() - wall, "start": wall}) + "\n")
