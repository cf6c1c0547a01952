"""The port's convergence runs (``gcanet_tpu_torch/convergence_run.py``,
``gcanet_tpu_torch/scene_convergence_run.py``) against the JAX tools they
port, ``tools/convergence_run.py`` and ``tools/scene_convergence_run.py``,
without compiling a JAX step:

* the argparse flags and defaults equal the JAX tools' (read from their
  source with ``ast``), plus ``--device``;
* the ``Config`` equals, field by field, the one the JAX tool's expression
  builds (copied below with its lines cited) from the same flags;
* the held-out objects and scenes, and the first two training batches of
  seeds 0 and 1 (flagship with and without ``--hard``), equal the JAX
  package's draws bit for bit, at the tools' default widths;
* the host half of each evaluation gives exactly what the JAX tool's lines
  give through the JAX package's numpy metrics and ``instance_eval`` on
  the same random host arrays;
* a toy run of each (2 steps, an eval every step) on the CPU writes the
  JAX rows (keys, rounding) after a header, prints them and ``done``, and
  ``tools/gate_report.py`` reads the file; without a card and without
  ``--device cpu`` each tool raises.
"""

import argparse
import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.config import scene_grouping_defaults as jscene_grouping_defaults
from gcanet_tpu.data.synthetic import synth_batch as jsynth_batch
from gcanet_tpu.data.synthetic import synth_scene_batch as jsynth_scene_batch
from gcanet_tpu.train import instance_eval as jinstance_eval
from gcanet_tpu.train import instances as jinst
from gcanet_tpu.train import metrics as JM
from gcanet_tpu_torch import convergence_run, scene_convergence_run
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
JAX_TOOL = {"abc": TOOLS / "convergence_run.py", "scene": TOOLS / "scene_convergence_run.py"}
PORT = {"abc": convergence_run, "scene": scene_convergence_run}


def _load(path: Path):
    """A JAX-side tool module by path (its ``main`` runs only as a script)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_flags(path: Path) -> dict:
    """``{flag: {type, default, action}}`` of the tool's ``add_argument``
    calls, from its source."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags[node.args[0].value] = {
                k.arg: k.value.id if isinstance(k.value, ast.Name) else ast.literal_eval(k.value)
                for k in node.keywords if k.arg != "help"}
    return flags


def _port_flags(parser: argparse.ArgumentParser) -> dict:
    flags = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._StoreTrueAction):
            flags[a.option_strings[0]] = {"action": "store_true"}
        else:
            flags[a.option_strings[0]] = dict(
                {"type": a.type.__name__} if a.type else {}, default=a.default)
    return flags


def _jax_row_keys(path: Path) -> list:
    """The keys of the ``row = {...}`` the tool writes."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "row":
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no row in {path}")


def test_flags_match_the_jax_tools():
    """The same flags and defaults; ``--out`` the same file name, under the
    temporary directory where the JAX tools name ``/tmp``."""
    for family in ("abc", "scene"):
        port = _port_flags(PORT[family].parser())
        assert port.pop("--device") == {"default": None}
        jax_flags = _jax_flags(JAX_TOOL[family])
        for flags in (port, jax_flags):
            flags["--out"]["default"] = Path(flags["--out"]["default"]).name
        assert port == jax_flags, family


def _jax_abc_config(args):
    """tools/convergence_run.py:79-87."""
    knn_impl = "xla" if args.recall == "exact" else f"approx:{args.recall}"
    return JConfig(num_points=args.points, batch_size=args.batch,
                   max_instances=args.max_instances, knn_impl=knn_impl,
                   encoder_bf16=args.encoder_bf16,
                   shared_graph=args.shared_graph,
                   nn_nb_inner=args.nn_nb_inner,
                   instance_head=JIHConfig(
                       max_proposals=args.max_proposals),
                   **({"nn_nb": args.nn_nb} if args.nn_nb else {}))


def _jax_scene_config(args):
    """tools/scene_convergence_run.py:63-77."""
    kw = {}
    if args.max_proposals:
        kw["instance_head"] = JIHConfig(
            max_proposals=args.max_proposals)
    return JConfig(num_points=args.points, batch_size=args.batch,
                   scene_bf16=args.bf16,
                   scene_soft_grouping=bool(args.soft),
                   grouping=jscene_grouping_defaults(
                       class_numpoint_mean=(args.points / 5.0,) * 10), **kw)


CONFIGS = {
    "abc_defaults": ("abc", []),
    "abc_knobs": ("abc", ["--hard", "--recall", "exact", "--nn-nb", "16", "--shared-graph"]),
    "scene_defaults": ("scene", []),
    "scene_knobs": ("scene", ["--bf16", "--soft", "0", "--max-proposals", "8"]),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_matches_the_jax_tool(case):
    family, argv = CONFIGS[case]
    args = PORT[family].parser().parse_args(argv)
    want = (_jax_abc_config if family == "abc" else _jax_scene_config)(args)
    assert dataclasses.asdict(PORT[family].make_config(args)) == dataclasses.asdict(want)


def _same_batches(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = {k: v for k, v in w.items() if k != "index"}
        assert set(g) - {"index"} == set(w)
        for k, v in w.items():
            assert np.asarray(g[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(g[k], v, err_msg=k)


def test_data_matches_the_jax_draws():
    """Eval objects and scenes, and the first two training batches of seeds
    0 and 1, at the tools' default widths."""
    jtool = _load(JAX_TOOL["abc"])
    for hard in ([], ["--hard"]):
        for seed in (0, 1):
            args = convergence_run.parser().parse_args(hard + ["--seed", str(seed),
                                                               "--steps", "2"])
            cfg, jcfg = convergence_run.make_config(args), _jax_abc_config(args)
            make_batch = jtool.harder_mix if args.hard else \
                (lambda c, s: jsynth_batch(c, args.batch, seed=s))          # :94-95
            _same_batches(list(convergence_run.train_batches(cfg, args)),
                          [make_batch(jcfg, args.seed * 100_000 + 1000 + step)
                           for step in range(args.steps)])                  # :131-135
        ecfg = jcfg.replace(batch_size=1)                                   # :97-103
        eval_range = (8, 17) if args.hard else (3, 9)
        _same_batches(convergence_run.eval_objects(cfg, args),
                      [jsynth_batch(ecfg, 1, seed=90000 + i, inst_range=eval_range)
                       for i in range(args.eval_objects)])
    for seed in (0, 1):
        args = scene_convergence_run.parser().parse_args(["--seed", str(seed), "--steps", "2"])
        cfg, jcfg = scene_convergence_run.make_config(args), _jax_scene_config(args)
        _same_batches(list(scene_convergence_run.train_batches(cfg, args)),
                      [jsynth_scene_batch(jcfg, args.batch,
                                          seed=args.seed * 100_000 + 1000 + step)
                       for step in range(args.steps)])                      # :145-149
    ecfg = jcfg.replace(batch_size=1)                                       # :99-101
    _same_batches(scene_convergence_run.eval_scenes(cfg, args),
                  [jsynth_scene_batch(ecfg, 1, seed=90000 + i)
                   for i in range(args.eval_scenes)])


def _jax_object_metrics(results, objects):
    """tools/convergence_run.py:106-116, the device outputs given."""
    mious, tmious = [], []
    for (merged, tpp), eb in zip(results, objects):
        i_gt = np.asarray(eb["I_gt"])[0]
        t_gt = np.asarray(eb["T_gt"])[0]
        pred_t = np.argmax(tpp[0], -1)
        merged = np.asarray(merged).reshape(-1)   # [N] (batch-1 eval)
        mious.append(JM.compute_miou(merged, i_gt))
        tmious.append(JM.compute_type_miou_abc(pred_t, t_gt, merged, i_gt))
    return float(np.mean(mious)), float(np.mean(tmious))


def _jax_scene_metrics(hosts, eval_batches, cfg):
    """tools/scene_convergence_run.py:109-135, the device outputs given."""
    cls_offset = 2
    class_ids = list(range(cls_offset, cfg.num_primitives - 1 + cls_offset))
    scenes, miou_sum, acc_sum = [], 0.0, 0.0
    for b, dev in zip(eval_batches, hosts):
        keep, conf, npoint, mask_bits, sem_pred = dev
        masks = jinst.unpack_mask_bits(mask_bits, int(b["xyz"].shape[1]))
        gt_sem = np.asarray(b["semantic"][0])
        pw = jinstance_eval.pointwise_semantic_eval(
            sem_pred[0] if sem_pred.ndim > 1 else sem_pred, gt_sem,
            cfg.num_primitives, ignore_label=-100)
        miou_sum += pw["miou"]
        acc_sum += pw["acc"]
        preds = jinst.instances_from_masks(
            keep, conf, npoint, masks,
            label_offset=cls_offset, encode_rle=False)
        bg_label = (cfg.num_primitives - 1) + cls_offset
        preds = [p for p in preds if p["label_id"] < bg_label]
        scenes.append({"preds": preds,
                       "gt_inst": np.asarray(b["instance"][0]),
                       "gt_sem": gt_sem})
    ap = jinstance_eval.evaluate_matches(scenes, class_ids, min_npoint=1)
    n = len(eval_batches)
    return miou_sum / n, acc_sum / n, float(ap["all_ap_50%"])


def test_host_eval_matches_the_jax_tools():
    """Random labels and types for the flagship; for the scene family
    random masks that overlap the ground-truth instances, random scores,
    keeps and semantic predictions (some points ignored)."""
    rng = np.random.default_rng(0)
    n, c = 300, 7
    objects, results = [], []
    for _ in range(3):
        i_gt = rng.integers(0, 5, n)
        objects.append({"I_gt": i_gt[None], "T_gt": rng.integers(0, 10, (1, n))})
        merged = np.where(rng.random(n) < 0.8, i_gt, rng.integers(0, 7, n)).astype(np.int32)
        results.append((merged, rng.standard_normal((1, n, c)).astype(np.float32)))
    got = convergence_run.object_metrics(results, objects)
    assert got == _jax_object_metrics(results, objects)
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] <= 1.0

    args = scene_convergence_run.parser().parse_args(["--points", "256"])
    cfg = scene_convergence_run.make_config(args)
    ci, p = cfg.num_primitives, 12
    scenes, hosts = [], []
    for _ in range(3):
        inst = rng.integers(0, 6, n).astype(np.int32)
        sem = (rng.integers(0, 8, 6)[inst] + 2).astype(np.int32)
        sem[rng.random(n) < 0.05] = -100
        scenes.append({"xyz": rng.random((1, n, 3)).astype(np.float32),
                       "semantic": sem[None], "instance": inst[None]})
        masks = np.zeros((p, n, ci), bool)
        for q in range(p):
            member = (inst == q % 6) & (rng.random(n) < 0.9)
            masks[q, :, rng.integers(0, ci)] = member
            masks[q, :, rng.integers(0, ci)] |= rng.random(n) < 0.05
        bits = np.packbits(masks.transpose(0, 2, 1), axis=-1, bitorder="little")
        keep = rng.random((p, ci)) < 0.5
        conf = rng.random((p, ci)).astype(np.float32)
        npoint = masks.sum(1).astype(np.int32)
        sem_pred = np.where(rng.random(n) < 0.7, np.maximum(sem, 0),
                            rng.integers(0, ci, n))[None]
        hosts.append([keep, conf, npoint, bits, sem_pred])
    got = scene_convergence_run.scene_metrics(hosts, scenes, cfg.num_primitives)
    assert got == _jax_scene_metrics(hosts, scenes, cfg)
    assert all(0.0 < v < 1.0 for v in got), got


def _gate_report():
    return _load(TOOLS / "gate_report.py")


TOY = {
    "abc": ["--steps", "2", "--eval-every", "1", "--points", "128", "--batch", "2",
            "--eval-objects", "2", "--max-instances", "8", "--max-proposals", "8",
            "--nn-nb", "16"],
    "scene": ["--steps", "2", "--eval-every", "1", "--points", "256", "--grid", "8",
              "--batch", "2", "--eval-scenes", "2", "--max-proposals", "8"],
}


@pytest.mark.parametrize("family", sorted(TOY))
def test_toy_run_writes_the_jax_rows(family, tmp_path, capsys, monkeypatch):
    module, path = PORT[family], tmp_path / f"{family}.jsonl"
    with monkeypatch.context() as no_card:
        no_card.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(TOY[family] + ["--out", str(path)])
    argv = TOY[family] + ["--device", "cpu", "--out", str(path)]
    module.main(argv)
    printed = capsys.readouterr().out.splitlines()
    header, rows = _gate_report().load_run(str(path))
    assert header == f"cpu; python -m {module.__name__} {' '.join(argv)}"
    assert sorted(rows) == [0, 1, 2]
    keys = _jax_row_keys(JAX_TOOL[family])
    assert printed == [json.dumps(rows[s]) for s in (0, 1, 2)] + ["done"]
    for step, row in rows.items():
        assert list(row) == keys and row["step"] == step
        for k, v in row.items():
            assert v == round(v, 1 if k == "t_min" else 4) or (k == "loss" and step == 0)
            if k == "loss":
                assert math.isnan(v) if step == 0 else v > 0
            elif k not in ("step", "t_min"):
                assert 0.0 <= v <= 1.0, row
    assert _gate_report().metric_keys(rows) == [k for k in keys if k not in ("step", "t_min")]
