"""Inference/serving API of the port (``gcanet_tpu/serve.py::Predictor``,
fast path).

``Predictor`` loads weights once, then ``predict`` / ``predict_batch`` run the
flagship model and the instance extraction on the device and copy the
results to the host in one transfer per call.  It runs on ``cuda`` unless the
caller passes ``device="cpu"``; it never moves to the CPU on its own.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.models.registry import build_model
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.utils.from_jax import load_reference_checkpoint
from gcanet_tpu_torch.utils.transfer import fetch


class Predictor:
    """Flagship-model serving with ``cluster_mode="grouping"``.

    ``checkpoint``: a reference-format ``.tar`` path, or a state_dict in the
    reference's or the port's layout (``utils/from_jax.py``); ``None`` keeps
    random weights seeded with ``cfg.seed``.  ``device``: default ``cuda``;
    raises when no card is present unless ``device="cpu"`` is asked for.
    """

    def __init__(self, cfg: Config,
                 checkpoint: str | Path | Mapping[str, torch.Tensor] | None = None,
                 device: str | torch.device | None = None,
                 cluster_mode: str = "grouping"):
        if cluster_mode != "grouping":
            raise NotImplementedError(f"cluster_mode={cluster_mode!r} is not ported "
                                      "yet; only 'grouping' (see ROADMAP.md)")
        if str(cfg.mesh_shape) not in ("1", ""):
            raise NotImplementedError("data-parallel serving is not ported yet")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor runs on cuda by default and no CUDA device "
                               "is available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.load_report = (load_reference_checkpoint(self.model, checkpoint)
                            if checkpoint is not None else None)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def _forward_fast(self, xyz: np.ndarray, normals: np.ndarray) -> List[torch.Tensor]:
        """Forward + on-device instance extraction for a ``[B, N, 3]`` batch."""
        xyz_t = torch.as_tensor(np.asarray(xyz, np.float32), device=self.device)
        nrm_t = torch.as_tensor(np.asarray(normals, np.float32), device=self.device)
        out = self.model(xyz_t, nrm_t)
        merged, keep, conf, npoint, covered = inst_utils.merged_labels_device(
            out.proposals.point_pid, out.instance.cls_scores,
            out.instance.iou_scores, out.instance.mask_scores,
            out.proposals.valid, self.cfg.num_primitives)
        return [merged, keep, conf, npoint, covered, out.proposals.batch,
                out.type_per_point, out.param_per_point, out.pt_offsets,
                out.embedding]

    def predict(self, xyz: np.ndarray, normals: np.ndarray,
                return_masks: bool = False, return_embedding: bool = False,
                panoptic: bool = False) -> Dict:
        """``xyz/normals [N, 3]`` -> per-point types/params/offsets and the
        instance list (RLE masks from the merged, non-overlapping labels)."""
        if return_masks or panoptic:
            raise NotImplementedError("return_masks and panoptic are not ported "
                                      "yet (see ROADMAP.md)")
        dev = self._forward_fast(np.asarray(xyz)[None], np.asarray(normals)[None])
        if not return_embedding:
            dev = dev[:-1]
        fetched = fetch(dev)
        merged, keep, conf, npoint, covered, _, tpp, ppp, off = fetched[:9]
        preds = inst_utils.instances_from_merged(merged, keep, conf, npoint, covered)
        return {
            "type_per_point": tpp[0],
            "param_per_point": ppp[0],
            "pt_offsets": off,
            "embedding": fetched[9][0] if return_embedding else None,
            "instances": preds,
            "instance_labels": merged,
        }

    def predict_batch(self, xyz: np.ndarray, normals: np.ndarray) -> List[Dict]:
        """``xyz/normals [B, N, 3]`` -> one prediction dict per cloud, with
        per-cloud instance labels re-compacted to 0..K-1."""
        if np.ndim(xyz) != 3:
            raise ValueError(f"predict_batch expects xyz [B, N, 3]; got shape "
                             f"{np.shape(xyz)} — use predict() for one [N, 3] cloud")
        b, n = np.shape(xyz)[:2]
        (merged, keep, conf, npoint, covered, prop_batch, tpp, ppp,
         off) = fetch(self._forward_fast(xyz, normals)[:-1])
        merged = merged.reshape(b, n)
        covered = covered.reshape(b, n)
        off = off.reshape(b, n, 3)
        results = []
        for bi in range(b):
            preds = inst_utils.instances_from_merged(
                merged[bi], keep, conf, npoint, covered[bi],
                prop_mask=(prop_batch == bi))
            local = np.zeros(n, np.int32)
            for local_id, inst in enumerate(preds):
                local[inst_utils.rle_decode(inst["pred_mask"]).astype(bool)] = local_id
            results.append({
                "type_per_point": tpp[bi],
                "param_per_point": ppp[bi],
                "pt_offsets": off[bi],
                "embedding": None,
                "instances": preds,
                "instance_labels": local,
            })
        return results

    def predict_stream(self, batches, depth: int = 2):
        raise NotImplementedError("predict_stream is not ported yet (see ROADMAP.md)")

    def predict_type_sharded(self, xyz: np.ndarray, normals: np.ndarray):
        raise NotImplementedError("predict_type_sharded is not ported yet "
                                  "(see ROADMAP.md)")
