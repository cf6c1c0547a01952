"""The slice as a whole: the port's ``Predictor`` (device="cpu") against the
JAX package's fast serving path (``model.apply`` + ``merged_labels_device``
in one jit, then ``Predictor._finalize_batch``), from the same numpy weights
on the same synthetic clouds.

Random weights leave every stage after grouping idle (no proposal passes
the instance thresholds), so the shared weights and constants are pushed
until the path does real work, and the test asserts that it does before it
compares anything:
  * every class mean is -1, so every component is a primary proposal, with
    radius 0.05 and the embedding gate at 0.9 so components span instances;
  * the offset head's last kernel is scaled by 0.05 (small, live offsets);
  * instance head: +10 on class 0's ``cls_linear`` bias and +10 on the
    mask MLP's last bias, so proposals clear cls 0.45 and mask -3.
Rules: floats at rtol=1e-4, atol=1e-5 (fp32, other summation order),
except ``conf``, which comes out of the bf16 instance head, at
rtol=atol=3e-2 (bf16 rounds at other places in the two frameworks' convs);
merged labels, keep/npoint/covered and the instance list (labels, RLE,
npoint) exactly.  The JAX model runs its instance head in bf16, so the
port runs it in bf16 too (its default); the pushed biases keep every
threshold far from bf16 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.models.primitive_net import PrimitiveNet as JPrimitiveNet
from gcanet_tpu.serve import Predictor as JPredictor
from gcanet_tpu.train import instances as jinst
from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_clouds
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)

N, B = 1024, 2
SMALL = dict(num_points=N, nn_nb=12, nn_nb_inner=8, offset_knn=6,
             offset_keypoints=24, knn_impl="xla")
GROUP = dict(radius=0.05, similarity_threshold_inst=0.9,
             class_numpoint_mean=(-1.0,) * 7, min_npoint=20)
HEAD = dict(grid_size=8, max_proposals=24)
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _jax_cfg():
    return JConfig(**SMALL, grouping=JGroupingConfig(**GROUP),
                   instance_head=JIHConfig(**HEAD))


def _port_cfg():
    return Config(**SMALL, grouping=GroupingConfig(**GROUP),
                  instance_head=InstanceHeadConfig(**HEAD))


@pytest.fixture(scope="module")
def setup():
    model = JPrimitiveNet(_jax_cfg())
    z = jnp.zeros((1, N, 3))
    v = jax.jit(lambda r: model.init({"params": r}, z, z, train=True, rng=r))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, v["params"])
    stats = jax.tree.map(np.array, v["batch_stats"])
    params["OffsetPredModule_0"]["Dense_0"]["kernel"] *= 0.05
    params["InstanceHead_0"]["Dense_0"]["bias"][0] += 10.0
    params["InstanceHead_0"]["MLP_0"]["Dense_1"]["bias"] += 10.0

    @jax.jit
    def forward_fast(p, s, xyz, normals):        # JAX Predictor._forward_fast
        out = model.apply({"params": p, "batch_stats": s}, xyz, normals,
                          train=False, rng=jax.random.PRNGKey(0))
        merged, keep, conf, npoint, covered = jinst.merged_labels_device(
            out.proposals.point_pid, out.instance.cls_scores,
            out.instance.iou_scores, out.instance.mask_scores,
            out.proposals.valid, 7)
        return (merged, keep, conf, npoint, covered, out.proposals.batch,
                out.type_per_point, out.param_per_point, out.pt_offsets,
                out.embedding)

    xyz, nrm = synth_clouds(_port_cfg(), B, seed=0)
    want_dev = forward_fast(params, stats, jnp.asarray(xyz), jnp.asarray(nrm))
    predictor = Predictor(_port_cfg(), checkpoint=state_dict_from_jax(params, stats),
                          device="cpu")
    return predictor, xyz, nrm, want_dev


def test_predictor_batch_matches_jax(setup):
    predictor, xyz, nrm, want_dev = setup
    with torch.inference_mode():
        out = predictor.model(torch.from_numpy(xyz), torch.from_numpy(nrm))
    got_dev = predictor._forward_fast(xyz, nrm)
    assert int(out.proposals.num) > 0
    assert int(got_dev[1].sum()) > 0, "no kept instance"
    assert int(got_dev[4].sum()) > 0, "no covered point"

    names = ("merged", "keep", "conf", "npoint", "covered", "prop_batch",
             "type_per_point", "param_per_point", "pt_offsets", "embedding")
    for name, g, w in zip(names, got_dev, want_dev):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name,
                                       **(BF16 if name == "conf" else FP32))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)

    # JAX package's own host-side split into per-cloud results
    want = JPredictor._finalize_batch(None, want_dev, B, N)
    got = predictor.predict_batch(xyz, nrm)
    assert sum(len(r["instances"]) for r in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["instance_labels"], w["instance_labels"])
        assert [(i["label_id"], i["npoint"], i["pred_mask"]) for i in g["instances"]] == \
               [(i["label_id"], i["npoint"], i["pred_mask"]) for i in w["instances"]]
        np.testing.assert_allclose([i["conf"] for i in g["instances"]],
                                   [i["conf"] for i in w["instances"]], **BF16)
        for key in ("type_per_point", "param_per_point", "pt_offsets"):
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **FP32)


def test_predict_single_cloud_matches_batch_item(setup):
    # grouping and every norm act per cloud, so cloud 0 alone gives the
    # batch's first result when no proposal of it was truncated
    predictor, xyz, nrm, _ = setup
    one = predictor.predict(xyz[0], nrm[0], return_embedding=True)
    first = predictor.predict_batch(xyz, nrm)[0]
    assert one["embedding"].shape == (N, 64)
    np.testing.assert_array_equal(one["instance_labels"], first["instance_labels"])
    assert [i["pred_mask"] for i in one["instances"]] == \
           [i["pred_mask"] for i in first["instances"]]


def test_predictor_refuses_unported_paths(setup):
    predictor, xyz, nrm, _ = setup
    with pytest.raises(NotImplementedError):
        predictor.predict(xyz[0], nrm[0], return_masks=True)
    with pytest.raises(NotImplementedError):
        Predictor(_port_cfg(), device="cpu", cluster_mode="meanshift")
    with pytest.raises(NotImplementedError):
        Predictor(_port_cfg().replace(model_dict="models.sppnet"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Predictor(_port_cfg())
