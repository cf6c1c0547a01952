"""Serving and training readings of one checkout, for comparing two commits
on one card in one call.

    python3 serve_ab.py

Run from the root of each checkout (copy this file into the older one);
alternate the checkouts (parent, change, change, parent).  It prints
``chip_smoke.py``'s phase 5 (serving at B=4, N=7000) and phase 8 (training
at B=3) lines, then 10-repetition medians of the model's forward and of
``predict_batch`` at B=4, N=7000, and the forward's device time by op.
Needs a CUDA device.
"""

from __future__ import annotations

import tempfile
import time

import torch

import chip_smoke
from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.data.synthetic import synth_clouds
from gcanet_tpu_torch.serve import Predictor


def _median_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2] * 1e3


def main() -> None:
    card, _ = chip_smoke.phase_card()
    chip_smoke.phase_build()
    chip_smoke.phase_serving(card, 0.0)
    with tempfile.TemporaryDirectory(dir=chip_smoke.kernels.BUILD_DIR.parent) as log_dir:
        chip_smoke.phase_training(log_dir)

    cfg = Config()
    pred = Predictor(cfg, device="cuda")
    chip_smoke.push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, 4, seed=2)
    xt, nt = torch.as_tensor(xyz, device="cuda"), torch.as_tensor(nrm, device="cuda")

    def forward():
        with torch.inference_mode():
            pred.model(xt, nt)

    for _ in range(3):
        pred.predict_batch(xyz, nrm)
    print(f"[ab] forward median {_median_ms(forward):.1f} ms; predict_batch median "
          f"{_median_ms(lambda: pred.predict_batch(xyz, nrm)):.1f} ms (B=4, N={cfg.num_points})")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_ = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = sum(e.count for e in events if e.device_type == DeviceType.CPU)
    print(f"[ab] forward device busy {sum(e.self_device_time_total for e in kernels_) / 1e3:.1f} "
          f"ms, {sum(e.count for e in kernels_)} kernels, {host_ops} host ops")


if __name__ == "__main__":
    main()
