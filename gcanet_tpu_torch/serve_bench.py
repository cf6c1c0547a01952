"""Serving throughput of the port: the forward, ``predict``, ``predict_batch``
and ``predict_stream`` paths (port of ``tools/serve_bench.py``).

    python -m gcanet_tpu_torch.serve_bench [--iters 20]
        [--paths fwd,predict,batch,stream] [--family abc|scene]
        [--scene-grid 48] [--device cpu]

The workload is the JAX tool's: ``config.py::bench_config`` (the
``GCA_BENCH_*`` knobs; ``GCA_BENCH_POINTS`` 8192, ``GCA_BENCH_BATCH`` 10,
``GCA_BENCH_NN``, ``GCA_BENCH_MESH``), the flagship with set aggregation on
and the ``Predictor``'s own seeded weights; the scene family
(``--family scene``) a ``ScenePredictor`` on the scannetv2 grouping recipe
with every class mean at ``N/5``, at ``--scene-grid``.  One synthetic batch
(seed 0) of ``B = GCA_BENCH_BATCH`` clouds is served.

Each path is warmed up once, then timed over ``--iters`` calls.  ``fwd``
(flagship only) times the model's forward at B=1 and at B on device tensors:
on a card with CUDA events around the loop and one synchronisation (the JAX
tool's device number), then again with the semantic scores copied to the
host after each call (``serve_forward_decomp_b*``: ``device_ms_per_cloud``
and the copy's ``fetch_ms_per_cloud``).  ``predict``, ``batch`` and
``stream`` end on the host and are timed by the host clock.  Under
``GCA_BENCH_MESH`` > 1 the predictor serves over that many devices and
``fwd`` and ``predict`` are skipped, as the JAX tool skips them.

Prints one line ``{"sweeps_per_cloud": {...}}`` (how many times each path
launched the CUDA connected-components sweep, ``csrc/cc_sweep.cu``, per
cloud served; 0 on the CPU, where the sweep's plain version runs), then one
JSON line per path with the JAX tool's metric names and fields.  It runs on
the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gcanet_tpu_torch.config import bench_config, scene_grouping_defaults
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_scene_batch
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.parallel.dist import mesh_size
from gcanet_tpu_torch.serve import Predictor, ScenePredictor

PATHS = ("fwd", "predict", "batch", "stream")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma subset of fwd,predict,batch,stream")
    ap.add_argument("--family", default="abc", choices=["abc", "scene"],
                    help="scene = ScenePredictor: predict/batch/stream paths")
    ap.add_argument("--scene-grid", type=int, default=48, help="scene voxel grid")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def _serving_devices(device: str | None, n: int):
    """The predictor's ``device=``: ``None`` (its default, ``cuda`` or
    ``cuda:0`` .. ``cuda:n-1``) or ``device`` once per mesh device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the serving bench runs on cuda by default and no CUDA device "
                               "is available; pass --device cpu to run it on the CPU")
        return None
    return [device] * n if n > 1 else device


class _Clock:
    """Seconds of a loop: CUDA events on a card (one synchronisation at the
    end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.seconds = self.start.elapsed_time(self.end) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0


class _Run:
    """The bench's lines: metric rows, and each path's sweep launches per
    cloud, printed together at the end, the sweeps' line first."""

    def __init__(self, config: dict):
        self.config = config
        self.rows: list[dict] = []
        self.sweeps: dict[str, float] = {}

    def timed(self, key: str, clouds: int, loop) -> float:
        """``loop()``'s host-clock seconds, with the sweeps it launched
        counted."""
        before = cc.masked_min_sweep.launches
        t0 = time.perf_counter()
        loop()
        seconds = time.perf_counter() - t0
        self.count(key, clouds, before)
        return seconds

    def count(self, key: str, clouds: int, before: int) -> None:
        """The sweeps launched since the count stood at ``before``, per
        cloud; the counter itself is left running."""
        self.sweeps[key] = (cc.masked_min_sweep.launches - before) / clouds

    def emit(self, metric: str, clouds: int, seconds: float) -> None:
        self.rows.append({"metric": metric, "value": round(clouds / seconds, 3),
                          "unit": "clouds/s", "config": self.config})

    def print(self) -> list[dict]:
        lines = [{"sweeps_per_cloud": self.sweeps}] + self.rows
        for line in lines:
            print(json.dumps(line), flush=True)
        return lines


def _skip_on_mesh(paths: set, n: int, lines: list) -> set:
    """Under a mesh only the batched paths shard: drop ``fwd``/``predict``."""
    if n > 1 and paths & {"fwd", "predict"}:
        lines.append({"note": "mesh serving — fwd/predict skipped"})
        print(json.dumps(lines[-1]), flush=True)
        return paths & {"batch", "stream"}
    return paths


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the bench and print its lines; returns them as dicts."""
    args = _parser().parse_args(argv)
    if args.family == "scene":
        return scene_main(args)
    cfg = bench_config().replace(using_set_aggr=True)
    b = cfg.batch_size
    n_dev = mesh_size(cfg)
    pred = Predictor(cfg, device=_serving_devices(args.device, n_dev))
    notes: list[dict] = []
    paths = _skip_on_mesh(set(args.paths.split(",")), n_dev, notes)
    batch = synth_batch(cfg, b, seed=0)
    xyz = np.asarray(batch["gt_pc"], np.float32)
    nrm = np.asarray(batch["gt_normal"], np.float32)
    run = _Run({"points": cfg.num_points, "batch": b, "nn_nb": cfg.nn_nb,
                "iters": args.iters})

    if "fwd" in paths:
        _forward_paths(pred, xyz, nrm, args.iters, run)
    if "predict" in paths:
        pred.predict(xyz[0], nrm[0])                       # warm-up
        dt = run.timed("predict_b1", args.iters, lambda: [
            pred.predict(xyz[0], nrm[0]) for _ in range(args.iters)])
        run.emit("serve_predict_clouds_per_sec_b1", args.iters, dt)
    _batched_paths(pred, xyz, nrm, b, args.iters, paths, run, "serve_predict")
    return notes + run.print()


@torch.inference_mode()
def _forward_paths(pred: Predictor, xyz: np.ndarray, nrm: np.ndarray, iters: int,
                   run: _Run) -> None:
    """The model's forward at B=1 and B on device tensors: device-bound,
    then with the semantic scores copied to the host after each call."""
    model = pred.model
    for label, (x, n) in (("1", (xyz[:1], nrm[:1])), (str(len(xyz)), (xyz, nrm))):
        x, n = (torch.as_tensor(a, device=pred.device) for a in (x, n))
        model(x, n).semantic_scores.cpu()                  # warm-up
        before = cc.masked_min_sweep.launches
        with _Clock(pred.device) as device_loop:
            for _ in range(iters):
                model(x, n)
        with _Clock(pred.device) as fetch_loop:
            for _ in range(iters):
                model(x, n).semantic_scores.cpu()
        per = x.shape[0] * iters
        run.count(f"fwd_b{label}", 2 * per, before)
        run.emit(f"serve_forward_clouds_per_sec_b{label}", per, device_loop.seconds)
        run.rows.append({
            "metric": f"serve_forward_decomp_b{label}",
            "device_ms_per_cloud": round(1e3 * device_loop.seconds / per, 2),
            "fetch_ms_per_cloud": round(1e3 * (fetch_loop.seconds - device_loop.seconds)
                                        / per, 2),
            "unit": "ms",
        })


def _batched_paths(pred, xyz: np.ndarray, aux: np.ndarray, b: int, iters: int,
                   paths: set, run: _Run, prefix: str) -> None:
    """``predict_batch`` and ``predict_stream`` (the host work of batch i
    overlapping the device work of batch i+1) on the one batch."""
    if "batch" in paths:
        pred.predict_batch(xyz, aux)                       # warm-up
        dt = run.timed(f"batch_b{b}", b * iters,
                       lambda: [pred.predict_batch(xyz, aux) for _ in range(iters)])
        run.emit(f"{prefix}_batch_clouds_per_sec_b{b}", b * iters, dt)
    if "stream" in paths:
        list(pred.predict_stream([(xyz, aux)]))            # warm-up
        out = []
        dt = run.timed(f"stream_b{b}", b * iters, lambda: out.extend(
            pred.predict_stream((xyz, aux) for _ in range(iters))))
        run.emit(f"{prefix}_stream_clouds_per_sec_b{b}", len(out), dt)


def scene_main(args: argparse.Namespace) -> list[dict]:
    """The scene family: ``ScenePredictor`` ``predict`` / ``predict_batch`` /
    ``predict_stream`` on synthetic scenes at the bench shapes."""
    cfg = bench_config()
    cfg = cfg.replace(grouping=scene_grouping_defaults(
        cfg.grouping, class_numpoint_mean=(cfg.num_points / 5.0,) * 10))
    b = cfg.batch_size
    n_dev = mesh_size(cfg)
    pred = ScenePredictor(cfg, device=_serving_devices(args.device, n_dev),
                          scene_grid=args.scene_grid)
    notes: list[dict] = []
    paths = _skip_on_mesh(set(args.paths.split(",")) - {"fwd"}, n_dev, notes)
    batch = synth_scene_batch(cfg, b, seed=0)
    xyz = np.asarray(batch["xyz"], np.float32)
    feats = np.asarray(batch["feats"], np.float32)
    run = _Run({"points": cfg.num_points, "batch": b, "grid": args.scene_grid,
                "iters": args.iters})
    if "predict" in paths:
        pred.predict(xyz[0], feats[0])                     # warm-up
        dt = run.timed("predict_b1", args.iters, lambda: [
            pred.predict(xyz[0], feats[0]) for _ in range(args.iters)])
        run.emit("scene_serve_predict_clouds_per_sec_b1", args.iters, dt)
    _batched_paths(pred, xyz, feats, b, args.iters, paths, run, "scene_serve_predict")
    return notes + run.print()


if __name__ == "__main__":
    main()
