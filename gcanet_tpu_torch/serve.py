"""Inference/serving API of the port (``gcanet_tpu/serve.py``: ``Predictor``
and ``ScenePredictor``).

Each predictor loads weights once, then ``predict`` / ``predict_batch`` /
``predict_stream`` run the model and the instance extraction on the device
and copy the results to the host in one transfer per batch
(``predict(return_masks=True)`` copies the mask scores and extracts on the
host; the meanshift mode's ``predict`` adds the embedding's mean-shift
labels, computed on the device, to that copy).  It runs on ``cuda`` unless
the caller passes ``device="cpu"``; it never moves to the CPU on its own.

With ``cfg.mesh_shape = N`` > 1 a predictor serves data-parallel over a
list of ``N`` devices (``cuda:0`` .. ``cuda:N-1`` by default): a replica of
the model on each, every batch split into ``N`` contiguous chunks run by
one thread each (``parallel/chunks.py``), with the one-device result.
``predict`` then raises, as the JAX package's does under a mesh.

``Predictor.predict_type_sharded`` serves one cloud larger than
``num_points`` by sharding its point axis over the same devices (one
device: a ring of one step).
"""

from __future__ import annotations

import functools
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.geometry.affinity import mean_shift
from gcanet_tpu_torch.models.registry import build_model, check_instance_model
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.parallel.chunks import BatchChunks, run_chunks
from gcanet_tpu_torch.parallel.dist import mesh_size
from gcanet_tpu_torch.parallel.sharded_encoder import sharded_type_forward
from gcanet_tpu_torch.parallel.sharded_knn import shard_rows
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.utils.from_jax import load_reference_checkpoint
from gcanet_tpu_torch.utils.transfer import fetch


Device = str | torch.device


def _devices(cfg: Config, device: Device | Sequence[Device] | None,
             what: str) -> List[torch.device]:
    """The serving devices: ``mesh_shape`` of them (one device, or a list),
    by default ``cuda`` or ``cuda:0`` .. ``cuda:N-1``."""
    n = mesh_size(cfg)
    if device is None:
        device = "cuda" if n == 1 else [f"cuda:{i}" for i in range(n)]
    devs = [torch.device(d) for d in (device if isinstance(device, (list, tuple))
                                      else [device])]
    if len(devs) != n:
        raise ValueError(f"mesh_shape={cfg.mesh_shape} serves data-parallel on {n} "
                         f"device(s), got {len(devs)}: pass device=[...] with {n} devices")
    if any(d.type == "cuda" for d in devs):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(f"{what} runs on cuda by default and no CUDA device is "
                               f"available; pass device='cpu' to run on the CPU")
        missing = [str(d) for d in devs if d.type == "cuda" and (d.index or 0) >= count]
        if missing:
            raise RuntimeError(f"{what}: {missing} not visible ({count} CUDA devices)")
    return devs


def _replicas(model: torch.nn.Module, devices: List[torch.device],
              build: Callable[[], torch.nn.Module]) -> List[torch.nn.Module]:
    """``model`` on the first device and a copy (``build()`` loaded with its
    state) on each other one; devices that are equal share one replica."""
    by_device = {devices[0]: model.to(devices[0]).eval()}
    for dev in devices[1:]:
        if dev not in by_device:
            copy = build()
            copy.load_state_dict(model.state_dict())
            by_device[dev] = copy.to(dev).eval()
    return [by_device[d] for d in devices]


class _DataParallel:
    """What both predictors share: the replicas, the batch split into
    chunks, one thread each, and their results finalised chunk by chunk."""

    def _split(self, xyz: np.ndarray, aux: np.ndarray) -> List[Tuple[List, int]]:
        """Dispatch ``[B, N, 3]`` arrays: ``[(device tensors, items)]`` per
        chunk."""
        b = np.shape(xyz)[0]
        k = len(self.devices)
        if k == 1:
            return [(self._forward_fast(xyz, aux), b)]
        if b % k:
            raise ValueError(f"a batch of {b} does not split over mesh_shape={k} devices")
        step = b // k
        chunks = BatchChunks([step] * k)
        fns = [functools.partial(self._forward_fast, xyz[i * step:(i + 1) * step],
                                 aux[i * step:(i + 1) * step], i, chunks.chunk(i))
               for i in range(k)]
        return [(dev, step) for dev in run_chunks(fns, chunks)]

    def _finalize(self, parts: List[Tuple[List, int]], n: int) -> List[Dict]:
        return [r for dev, b in parts for r in self._finalize_batch(dev, b, n)]

    def _single(self, what: str) -> None:
        if len(self.devices) > 1:
            raise ValueError(f"{what} runs batch-1 and cannot shard over a mesh "
                             f"(cfg.mesh_shape > 1); use predict_batch/predict_stream with a "
                             f"batch divisible by the mesh size")

    def predict_stream(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                       depth: int = 2) -> Iterator[Dict]:
        """Iterate ``(xyz [B, N, 3], aux)`` batches and yield the per-item
        dicts of ``predict_batch`` in order; up to ``depth`` batches are run
        ahead of the oldest one's copy to the host."""
        return _stream(self._split, self._finalize, batches, depth)


def _stream(forward, finalize, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
            depth: int) -> Iterator[Dict]:
    """Dispatch up to ``depth`` batches ahead of the oldest one's copy to
    the host and host work, yielding per-item dicts in order."""
    pending = deque()
    for a, b in batches:
        pending.append((forward(a, b), np.shape(a)[1]))
        if len(pending) > depth:
            yield from finalize(*pending.popleft())
    while pending:
        yield from finalize(*pending.popleft())


class Predictor(_DataParallel):
    """Flagship-model serving.

    ``cluster_mode``: ``"grouping"`` (the gated grouping and the instance
    head's merged labels) or ``"meanshift"`` (``predict``'s
    ``instance_labels`` are the mean shift of the embedding at
    ``cfg.bandwidth``, computed on the device; the instances are the
    head's).  ``predict_batch`` and ``predict_stream`` always group.
    ``checkpoint``: a reference-format ``.tar`` path, or a state_dict in the
    reference's or the port's layout (``utils/from_jax.py``); ``None`` keeps
    random weights seeded with ``cfg.seed``.  ``device``: default ``cuda``;
    raises when no card is present unless ``device="cpu"`` is asked for;
    with ``cfg.mesh_shape = N`` > 1 a list of ``N`` devices (module
    docstring).  ``model`` is the first device's replica.
    """

    def __init__(self, cfg: Config,
                 checkpoint: str | Path | Mapping[str, torch.Tensor] | None = None,
                 device: Device | Sequence[Device] | None = None,
                 cluster_mode: str = "grouping"):
        check_instance_model(cfg, "Predictor")
        if cluster_mode not in ("grouping", "meanshift"):
            raise ValueError(f"cluster_mode={cluster_mode!r}: expected 'grouping' or "
                             "'meanshift'")
        self.cluster_mode = cluster_mode
        self.devices = _devices(cfg, device, "Predictor")
        self.device = self.devices[0]
        self.cfg = cfg
        self.model = build_model(cfg)
        self.load_report = (load_reference_checkpoint(self.model, checkpoint)
                            if checkpoint is not None else None)
        self.replicas = _replicas(self.model, self.devices, lambda: build_model(cfg))

    @torch.inference_mode()
    def _forward_fast(self, xyz: np.ndarray, normals: np.ndarray, replica: int = 0,
                      chunk=None) -> List[torch.Tensor]:
        """Forward + on-device instance extraction for a ``[B, N, 3]`` batch
        on replica ``replica``; ``chunk`` when the batch is one chunk of a
        larger one."""
        dev = self.devices[replica]
        xyz_t = torch.as_tensor(np.ascontiguousarray(xyz, np.float32), device=dev)
        nrm_t = torch.as_tensor(np.ascontiguousarray(normals, np.float32), device=dev)
        out = self.replicas[replica](xyz_t, nrm_t, chunk=chunk)
        merged, keep, conf, npoint, covered = inst_utils.merged_labels_device(
            out.proposals.point_pid, out.instance.cls_scores,
            out.instance.iou_scores, out.instance.mask_scores,
            out.proposals.valid, self.cfg.num_primitives)
        return [merged, keep, conf, npoint, covered, out.proposals.batch,
                out.type_per_point, out.param_per_point, out.pt_offsets,
                out.embedding]

    @torch.inference_mode()
    def _forward_masks(self, xyz: np.ndarray, normals: np.ndarray) -> List[np.ndarray]:
        """The forward of one cloud and one copy of what the host extraction
        reads: point_pid, semantic scores, the head's cls/iou/mask scores,
        proposal validity, types, params, offsets, embedding; in the
        meanshift mode also the embedding's mean-shift labels, computed on
        the device before the copy."""
        xyz_t, nrm_t = (torch.as_tensor(np.ascontiguousarray(a, np.float32)[None],
                                        device=self.device) for a in (xyz, normals))
        out = self.model(xyz_t, nrm_t)
        tensors = [out.proposals.point_pid, out.semantic_scores, out.instance.cls_scores,
                   out.instance.iou_scores, out.instance.mask_scores, out.proposals.valid,
                   out.type_per_point[0], out.param_per_point[0], out.pt_offsets,
                   out.embedding[0]]
        if self.cluster_mode == "meanshift":
            tensors.append(mean_shift(out.embedding, self.cfg.bandwidth)[0])
        return fetch(tensors)

    def predict(self, xyz: np.ndarray, normals: np.ndarray,
                return_masks: bool = False, return_embedding: bool = False,
                panoptic: bool = False) -> Dict:
        """``xyz/normals [N, 3]`` -> per-point types/params/offsets and the
        instance list.  By default the instances come from the merged,
        non-overlapping labels extracted on the device; ``return_masks``
        copies the head's mask scores to the host and runs ``get_instances``
        there, whose RLE masks may overlap as the reference's do (the
        embedding is returned too).  The meanshift mode takes that path, with
        the mean-shift labels of the embedding as ``instance_labels``.
        ``panoptic`` adds the fused ``class | id << 16`` labels
        (``panoptic_fusion``).  Raises under a mesh (``mesh_shape`` > 1)."""
        self._single("predict()")
        n = np.shape(xyz)[0]
        if return_masks or self.cluster_mode == "meanshift":
            fetched = self._forward_masks(xyz, normals)
            pid, sem, cls_s, iou_s, mask_s, valid, tpp, ppp, off, emb = fetched[:10]
            preds = inst_utils.get_instances(pid, sem, cls_s, iou_s, mask_s, valid,
                                             self.cfg.num_primitives)
            if self.cluster_mode == "meanshift":
                merged = fetched[10]
            else:
                merged = inst_utils.merge_masks(preds) if preds else np.zeros(n, np.int32)
            result = {"type_per_point": tpp, "param_per_point": ppp, "pt_offsets": off,
                      "embedding": emb, "instances": preds, "instance_labels": merged}
        else:
            dev = self._forward_fast(np.asarray(xyz)[None], np.asarray(normals)[None])
            if not return_embedding:
                dev = dev[:-1]
            fetched = fetch(dev)
            merged, keep, conf, npoint, covered, _, tpp, ppp, off = fetched[:9]
            result = {
                "type_per_point": tpp[0],
                "param_per_point": ppp[0],
                "pt_offsets": off,
                "embedding": fetched[9][0] if return_embedding else None,
                "instances": inst_utils.instances_from_merged(merged, keep, conf, npoint,
                                                              covered),
                "instance_labels": merged,
            }
        if panoptic:
            result["panoptic"] = inst_utils.panoptic_fusion(
                result["type_per_point"].argmax(-1), result["instances"],
                self.cfg.num_primitives)
        return result

    def predict_batch(self, xyz: np.ndarray, normals: np.ndarray) -> List[Dict]:
        """``xyz/normals [B, N, 3]`` -> one prediction dict per cloud, with
        per-cloud instance labels re-compacted to 0..K-1.  Under a mesh ``B``
        must divide by ``mesh_shape``."""
        if np.ndim(xyz) != 3:
            raise ValueError(f"predict_batch expects xyz [B, N, 3]; got shape "
                             f"{np.shape(xyz)} — use predict() for one [N, 3] cloud")
        return self._finalize(self._split(xyz, normals), np.shape(xyz)[1])

    def _finalize_batch(self, dev: List[torch.Tensor], b: int, n: int) -> List[Dict]:
        """One copy of a dispatched batch to the host, then per-cloud dicts."""
        (merged, keep, conf, npoint, covered, prop_batch, tpp, ppp,
         off) = fetch(dev[:-1])                     # the embedding is not copied
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

    def predict_type_sharded(self, xyz: np.ndarray, normals: np.ndarray) -> Dict:
        """Per-point semantics of ONE cloud of any size ``N`` divisible by
        the predictor's device count (no relation to ``cfg.num_points``), its
        point axis sharded over ``self.devices`` (ring kNN and ring-gathered
        edge convs, ``parallel/sharded_encoder.py``; one device: a ring of
        one step).  ``xyz/normals [N, 3]`` -> ``type_per_point [N, C]``
        (argmax: the semantic class), ``param_per_point [N, 22]``,
        ``embedding [N, out_dim]`` and ``types`` (the argmax), copied to the
        host once.  Grouping and instance extraction are not run.  The JAX
        predictor without a mesh shards over every local device; this one
        only over the devices it was given."""
        xyz = np.asarray(xyz, np.float32)
        normals = np.asarray(normals, np.float32)
        if xyz.ndim != 2 or xyz.shape[1] != 3 or normals.shape != xyz.shape:
            raise ValueError(f"xyz/normals must be [N, 3] with equal N; got "
                             f"{list(xyz.shape)} / {list(normals.shape)}")
        x6 = torch.from_numpy(np.concatenate([xyz, normals], axis=-1))
        shards = shard_rows(x6, self.devices)
        outs = sharded_type_forward(self.replicas, shards)
        home = self.devices[0]
        tpp, ppp, emb = fetch([torch.cat([t.to(home) for t in parts]) for parts in outs])
        return {"type_per_point": tpp, "param_per_point": ppp, "embedding": emb,
                "types": tpp.argmax(-1)}


class ScenePredictor(_DataParallel):
    """SoftGroup scene-family serving (``gcanet_tpu/serve.py::ScenePredictor``):
    per-scene semantic labels, offsets and scored, possibly overlapping
    instance masks.

    ``checkpoint``: a state_dict of the port's ``SoftGroupNet`` or a
    ``torch.save`` path holding one (``{"model_state_dict": ...}`` too);
    ``None`` keeps random weights seeded with ``cfg.seed``.  ``cls_offset``
    maps instance-class columns to the dataset's semantic ids (scannetv2:
    2, s3dis: 0, stpls3d: 1, kitti: 11).  ``device``: default ``cuda``;
    raises when no card is present unless ``device="cpu"`` is asked for;
    with ``cfg.mesh_shape = N`` > 1 a list of ``N`` devices (module
    docstring).  ``model`` is the first device's replica.
    """

    def __init__(self, cfg: Config,
                 checkpoint: str | Path | Mapping[str, torch.Tensor] | None = None,
                 device: Device | Sequence[Device] | None = None,
                 cls_offset: int = 2, scene_grid: int = 64):
        self.devices = _devices(cfg, device, "ScenePredictor")
        self.device = self.devices[0]
        self.cfg = cfg
        self.cls_offset = cls_offset

        def build():
            return SoftGroupNet(cfg, scene_grid=scene_grid, compute_bf16=bool(cfg.scene_bf16))

        self.model = build()
        self.load_report = (load_reference_checkpoint(self.model, checkpoint, family="scene")
                            if checkpoint is not None else None)
        self.replicas = _replicas(self.model, self.devices, build)

    @torch.inference_mode()
    def _forward_fast(self, xyz: np.ndarray, feats: np.ndarray, replica: int = 0,
                      chunk=None) -> List[torch.Tensor]:
        """Forward, the unmerged instance masks (bit-packed) and the
        semantic argmax on replica ``replica`` for a ``[B, N, 3]`` batch;
        ``chunk`` when the batch is one chunk of a larger one."""
        dev = self.devices[replica]
        xyz_t, feats_t = (torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
                          for a in (xyz, feats))
        out = self.replicas[replica](xyz_t, feats_t, chunk=chunk)
        keep, conf, npoint, masks = inst_utils.instance_masks_device(
            out.proposals.point_pid, out.instance.cls_scores, out.instance.iou_scores,
            out.instance.mask_scores, out.proposals.valid, self.cfg.num_primitives)
        return [keep, conf, npoint, inst_utils.pack_mask_bits(masks), out.proposals.batch,
                out.semantic_scores.argmax(dim=-1).to(torch.int32), out.pt_offsets]

    def _finalize_batch(self, dev: List[torch.Tensor], b: int, n: int) -> List[Dict]:
        """One copy of a dispatched batch to the host, then per-scene dicts:
        the kept instances of the scene without the background column (class
        C-1), and per-point labels where the higher-confidence instance wins
        a point two masks share (0 = none)."""
        keep, conf, npoint, mask_bits, prop_batch, sem_pred, off = fetch(dev)
        masks = inst_utils.unpack_mask_bits(mask_bits, b * n)
        sem_pred = sem_pred.reshape(b, n)
        off = off.reshape(b, n, 3)
        bg_label = (self.cfg.num_primitives - 1) + self.cls_offset
        results = []
        for bi in range(b):
            preds = inst_utils.instances_from_masks(
                keep, conf, npoint, masks[:, bi * n:(bi + 1) * n, :],
                prop_mask=(prop_batch == bi), label_offset=self.cls_offset)
            preds = [p for p in preds if p["label_id"] < bg_label]
            labels = np.zeros(n, np.int32)
            for rank1, p in sorted(enumerate(preds, start=1), key=lambda t: t[1]["conf"]):
                labels[inst_utils.rle_decode(p["pred_mask"]).astype(bool)] = rank1
            results.append({
                "semantic_preds": sem_pred[bi],
                "pt_offsets": off[bi],
                "instances": preds,
                "instance_labels": labels,
            })
        return results

    def predict(self, xyz: np.ndarray, feats: np.ndarray) -> Dict:
        """One scene: ``xyz [N, 3]`` in the unit cube, ``feats [N, 3]``
        colours.  Raises under a mesh (``mesh_shape`` > 1)."""
        self._single("predict()")
        xyz = np.asarray(xyz)
        return self._finalize_batch(self._forward_fast(xyz[None], np.asarray(feats)[None]),
                                    1, xyz.shape[0])[0]

    def predict_batch(self, xyz: np.ndarray, feats: np.ndarray) -> List[Dict]:
        """``xyz [B, N, 3]``, ``feats [B, N, 3]`` -> one dict per scene.
        Under a mesh ``B`` must divide by ``mesh_shape``."""
        if np.ndim(xyz) != 3:
            raise ValueError(f"predict_batch expects xyz [B, N, 3]; got {np.shape(xyz)}")
        return self._finalize(self._split(xyz, feats), np.shape(xyz)[1])
