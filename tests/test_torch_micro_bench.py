"""The port's per-stage timer (``gcanet_tpu_torch/micro_bench.py``) against
the JAX tool it ports, ``tools/micro_bench.py``.

The timer runs in-process on the CPU at ``tests/test_torch_bench.py``'s toy
knobs (B=2, N=128, K=16, 8 proposals) with every stage and ``edgebwd``.
Its ``time_fn`` is wrapped to call each stage once and record the counts
the tool asks for, which must be the JAX tool's (10 calls after 2; the
full train step 5 after 1).  The timer must print a device line, then one
line per timing under the names the JAX tool formats, in its order (read
from its source text with ``ast``: the JAX tool runs at import), each value
finite and positive.  It reads no launch counter and resets none.  Without
a card it raises unless the CPU is asked for; its default stages are the
JAX tool's.
"""

import ast
import math
import time
from pathlib import Path

import pytest
import torch

from gcanet_tpu_torch import micro_bench
from gcanet_tpu_torch.config import bench_config
from gcanet_tpu_torch.ops import cc
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOY = {"GCA_BENCH_BATCH": "2", "GCA_BENCH_POINTS": "128", "GCA_BENCH_PROPOSALS": "8",
       "GCA_BENCH_NN": "16"}
JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "micro_bench.py"


def _jax_lines(cfg) -> list:
    """The names ``tools/micro_bench.py`` reports, in source order: each
    ``report(...)`` call's first argument, its f-strings evaluated under
    the enclosing ``for`` loops (over literal tuples) and ``cfg``."""
    names = []

    def visit(node, env):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            for value in ast.literal_eval(node.iter):
                for child in node.body:
                    visit(child, {**env, node.target.id: value})
            return
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "report":
            arg = node.args[0]
            names.append(arg.value if isinstance(arg, ast.Constant) else "".join(
                v.value if isinstance(v, ast.Constant) else
                str(eval(compile(ast.Expression(v.value), str(JAX_TOOL), "eval"), {}, env))
                for v in arg.values))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, env)

    visit(ast.parse(JAX_TOOL.read_text()), {"cfg": cfg})
    return names


def _jax_default_stages() -> list:
    """``STAGES``' default list in the JAX tool (the ``else`` branch)."""
    for node in ast.walk(ast.parse(JAX_TOOL.read_text())):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "STAGES":
            return ast.literal_eval(node.value.orelse)
    raise AssertionError("no STAGES in the JAX tool")


@pytest.fixture
def env(monkeypatch):
    for k in ("GCA_BENCH_MESH", "GCA_BENCH_NN_INNER", "GCA_BENCH_KNN", "GCA_BENCH_CC_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TOY.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def test_lines_match_the_jax_tool(env, capsys):
    asked = []

    def one_call(fn, *args, iters=10, warmup=2):
        asked.append((iters, warmup))
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    env.setattr(micro_bench, "time_fn", one_call)
    env.setattr(cc.masked_min_sweep, "launches", 7)
    lines = micro_bench.main([",".join(micro_bench.STAGES + micro_bench.OPT_IN),
                              "--device", "cpu"])
    assert cc.masked_min_sweep.launches == 7            # never reset
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "device: cpu"
    assert printed[1:] == [f"{name:28s} {ms:9.2f} ms" for name, ms in lines]
    assert [name for name, _ in lines] == _jax_lines(bench_config())
    assert all(math.isfinite(ms) and ms > 0 for _, ms in lines), lines
    assert asked == [(10, 2)] * (len(lines) - 1) + [(5, 1)]     # the step last


def test_default_stages_and_the_refusal(env):
    assert micro_bench._parser().parse_args([]).stages.split(",") == _jax_default_stages()
    with pytest.raises(ValueError, match="unknown stages"):
        micro_bench.main(["knn,nope", "--device", "cpu"])
    env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro_bench.main([])
