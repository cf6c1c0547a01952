"""The port's serving bench (``gcanet_tpu_torch/serve_bench.py``) against
the JAX tool it ports, ``tools/serve_bench.py``.

The bench runs in-process on the CPU at ``tests/test_torch_bench.py``'s toy
sizes (B=2, N=128, K=16, 8 proposals, one timed call per path; scene grid
8) and must print one JSON line per metric of the JAX tool, under the names
its source formats (read from the source text: running the JAX tool would
compile its predictor), with the same fields; before them the line of
sweeps per cloud, one per path.  Under ``GCA_BENCH_MESH=2`` it serves over
two CPU devices and skips ``fwd`` and ``predict`` with the JAX tool's
note.  The bench reads the sweep's launch counter and never resets it, so
a caller's count covers the whole run.  Without a card it raises unless
the CPU is asked for.
"""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from gcanet_tpu_torch import serve_bench
from gcanet_tpu_torch.ops import cc
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOY = {"GCA_BENCH_BATCH": "2", "GCA_BENCH_POINTS": "128", "GCA_BENCH_PROPOSALS": "8",
       "GCA_BENCH_NN": "16"}
JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "serve_bench.py"


def _jax_metric_names(b: int) -> set:
    """Every metric name ``tools/serve_bench.py`` formats, at batch ``b``
    (``{label}`` is 1 or ``b``)."""
    tree = ast.parse(JAX_TOOL.read_text())
    parts = {id(v) for node in ast.walk(tree) if isinstance(node, ast.JoinedStr)
             for v in node.values}
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            text = "".join(v.value if isinstance(v, ast.Constant) else
                           "{" + ast.unparse(v.value) + "}" for v in node.values)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in parts:
            text = node.value
        else:
            continue
        if text.startswith(("serve_", "scene_serve_")):
            names |= {text.format(label=label, b=b) for label in (1, b)}
    return names


@pytest.fixture
def env(monkeypatch):
    for k in ("GCA_BENCH_MESH", "GCA_BENCH_NN_INNER", "GCA_BENCH_KNN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TOY.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


CASES = {
    "abc": ([], "1", {"nn_nb": 16}, {"fwd_b1", "fwd_b2", "predict_b1", "batch_b2",
                                     "stream_b2"}),
    "abc_mesh2": ([], "2", {"nn_nb": 16}, {"batch_b2", "stream_b2"}),
    "scene": (["--family", "scene", "--scene-grid", "8"], "1", {"grid": 8},
              {"predict_b1", "batch_b2", "stream_b2"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lines_match_the_jax_tool(env, capsys, case):
    argv, mesh, config, sweep_keys = CASES[case]
    env.setenv("GCA_BENCH_MESH", mesh)
    env.setattr(cc.masked_min_sweep, "launches", 7)
    returned = serve_bench.main(argv + ["--iters", "1", "--device", "cpu"])
    assert cc.masked_min_sweep.launches == 7            # read, never reset
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert lines == returned
    if mesh != "1":
        assert lines.pop(0) == {"note": "mesh serving — fwd/predict skipped"}
    assert lines[0] == {"sweeps_per_cloud": {k: 0.0 for k in sweep_keys}}   # no card here
    rows = lines[1:]
    names = [r["metric"] for r in rows]
    family = "scene_" if case == "scene" else ""
    want = {n for n in _jax_metric_names(2) if n.startswith(family + "serve_")}
    if mesh != "1":
        want = {n for n in want if "batch" in n or "stream" in n}
    assert sorted(names) == sorted(want)
    for r in rows:
        if "decomp" in r["metric"]:
            assert set(r) == {"metric", "device_ms_per_cloud", "fetch_ms_per_cloud", "unit"}
            assert r["unit"] == "ms" and r["device_ms_per_cloud"] > 0
            assert math.isfinite(r["fetch_ms_per_cloud"])
        else:
            assert set(r) == {"metric", "value", "unit", "config"}
            assert r["unit"] == "clouds/s" and r["value"] > 0
            assert r["config"] == {"points": 128, "batch": 2, **config, "iters": 1}


def test_refuses_to_run_on_the_cpu_unasked(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--family", "scene"]):
        with pytest.raises(RuntimeError, match="pass --device cpu"):
            serve_bench.main(argv)
