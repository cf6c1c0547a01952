"""The scene family's grouping and instance extraction in the PyTorch port
against the JAX package, on the same inputs: ``scene_grouping_defaults``,
``synth_scene``, ``radius_neighbor_mask``, ``build_soft_proposals``,
``instance_masks_device``, the mask bit-packing and ``instances_from_masks``.

Every output here but ``conf`` is an integer, a bool or a copy, and is held
exactly; ``conf`` (a softmax in another summation order) at rtol 1e-6.  Soft
grouping thresholds floats that the two frameworks could round
apart in the last bits: the softmax against ``score_thr``, so each input
set is checked to hold no score within 1e-5 of it; and squared distances
against ``radius**2``, so the coordinates lie on a 2**-10 grid, where every
squared distance is exact in float32 (checked) and at least 2.6e-7 from
0.03**2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import scene_grouping_defaults as jscene_grouping_defaults
from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.data import synthetic as jsynthetic
from gcanet_tpu.ops import grouping as jgrouping
from gcanet_tpu.train import instances as jinst
from gcanet_tpu_torch.config import Config, GroupingConfig, scene_grouping_defaults
from gcanet_tpu_torch.data import synthetic as tsynthetic
from gcanet_tpu_torch.ops import grouping as tgrouping
from gcanet_tpu_torch.train import instances as tinst
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

C = 7                                    # classes 0/1 ignored: 5 grouped


@pytest.mark.parametrize("base,means", [(False, None), (True, None), (True, (13.0,) * 20)])
def test_scene_grouping_defaults_match_jax(base, means):
    kw = dict(radius=0.05, min_npoint=9, class_numpoint_mean=(1.0, 2.0))
    got = scene_grouping_defaults(GroupingConfig(**kw) if base else None, means)
    want = jscene_grouping_defaults(JGroupingConfig(**kw) if base else None, means)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.class_numpoint_mean == (means or (kw["class_numpoint_mean"] if base
                                                 else GroupingConfig().class_numpoint_mean))


def test_synth_scene_bit_for_bit():
    cfg = dict(num_points=301, num_primitives=20, max_instances=16)
    got = tsynthetic.synth_scene_batch(Config(**cfg), 3, seed=7)
    want = jsynthetic.synth_scene_batch(JConfig(**cfg), 3, seed=7)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key == "index":
            assert got[key] == w
            continue
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    # one stream of draws: the next scene from the same state agrees too
    rs_t, rs_j = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        a = tsynthetic.synth_scene(Config(**cfg), rs_t, n_instances=4, cls_offset=1)
        b = jsynthetic.synth_scene(JConfig(**cfg), rs_j, n_instances=4, cls_offset=1)
        for key in ("xyz", "feats", "semantic", "instance", "pt_offset_label", "inst_cls"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_compact_instance_label_matches_jax():
    from gcanet_tpu.data.scene_dataset import compact_instance_label as jcompact
    from gcanet_tpu_torch.data.scene_dataset import compact_instance_label

    for labels in (np.array([7, -100, 3, 7, 12, 3, -1], np.int32),
                   np.full(5, -100, np.int32), np.zeros(0, np.int32)):
        np.testing.assert_array_equal(compact_instance_label(labels), jcompact(labels))


def _scene_inputs(seed, b, n, blobs=6):
    """Shifted coordinates as gaussian blobs, and logits that put each blob
    in one grouped class, a few blobs in two (two equal logits: both
    softmax scores near 0.5) and scattered noise points in class 6 only
    (too few for ``min_npoint``)."""
    rng = np.random.RandomState(seed)
    shifted = np.empty((b, n, 3), np.float32)
    logits = np.zeros((b, n, C), np.float32)
    for i in range(b):
        owner = rng.randint(blobs, size=n)
        centers = rng.rand(blobs, 3) * 0.8 + 0.1
        shifted[i] = centers[owner] + rng.randn(n, 3) * rng.uniform(0.008, 0.02, (blobs, 1))[owner]
        cls = rng.randint(2, 6, size=blobs)
        logits[i, np.arange(n), cls[owner]] = 6.0
        two = rng.rand(blobs) < 0.3
        second = np.where(cls == 5, 2, cls + 1)
        both = two[owner]
        logits[i, np.nonzero(both)[0], second[owner][both]] = 6.0
        noise = rng.rand(n) < 0.02
        logits[i, noise] = 0.0
        logits[i, noise, 6] = 6.0
        shifted[i, noise] = rng.rand(int(noise.sum()), 3)
    logits += rng.uniform(-0.5, 0.5, logits.shape).astype(np.float32)
    return np.round(shifted * 1024) / 1024, logits


def _check_margins(shifted, logits, gcfg):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    scores = e / e.sum(-1, keepdims=True)
    assert np.abs(scores - gcfg.score_thr).min() > 1e-5
    x = shifted.astype(np.float64)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(tgrouping.pairwise_sqdist(torch.from_numpy(shifted)).numpy(),
                                  d2.astype(np.float32))
    assert np.abs(d2 - gcfg.radius ** 2).min() > 2.6e-7


CASES = {
    # two classes share points; class 6 fails min_npoint; -1 means mix in;
    # B * N = 486, not a multiple of 8
    "overlap": dict(seed=0, b=2, n=243, p=64, means=(-1.0, -1.0, 40.0, -1.0, 40.0, 30.0, 30.0)),
    # more proposals than max_proposals: truncated class-major
    "truncate": dict(seed=1, b=2, n=240, p=5, means=(40.0,) * 7),
    # gc * B * N < max_proposals: padded ranks (B * N = 15, not a multiple of 8)
    "tiny": dict(seed=2, b=1, n=15, p=100, means=(2.0,) * 7),
    # class 6 reaches min_npoint over the whole batch, in neither item alone;
    # its mean -1 keeps its singleton clusters
    "batchwide": dict(seed=3, b=2, n=240, p=100, means=(40.0,) * 6 + (-1.0,)),
}


def _min_npoint(name, logits):
    """12, 1 at the tiny size; for "batchwide" class 6's member count over
    the batch."""
    if name == "batchwide":
        e = np.exp(logits - logits.max(-1, keepdims=True))
        member6 = (e / e.sum(-1, keepdims=True))[..., 6] > 0.2
        assert (member6.sum(1) < member6.sum()).all()
        return int(member6.sum())
    return 12 if logits.shape[1] > 100 else 1


@pytest.fixture(scope="module", params=list(CASES))
def soft_case(request):
    c = CASES[request.param]
    shifted, logits = _scene_inputs(c["seed"], c["b"], c["n"])
    kw = dict(radius=0.03, min_npoint=_min_npoint(request.param, logits))
    gcfg = scene_grouping_defaults(GroupingConfig(**kw), c["means"])
    jcfg = jscene_grouping_defaults(JGroupingConfig(**kw), c["means"])
    _check_margins(shifted, logits, gcfg)
    want = jax.jit(lambda s, lg: jgrouping.build_soft_proposals(s, lg, C, jcfg, c["p"]))(
        jnp.asarray(shifted), jnp.asarray(logits))
    got = tgrouping.build_soft_proposals(torch.from_numpy(shifted), torch.from_numpy(logits),
                                         C, gcfg, max_proposals=c["p"])
    return request.param, shifted, logits, got, [np.asarray(w) for w in want]


def test_build_soft_proposals_exact(soft_case):
    name, shifted, logits, got, want = soft_case
    for field, w in zip(tgrouping.Proposals._fields, want):
        g = getattr(got, field).numpy()
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    pid = got.point_pid.numpy()
    assert pid.shape == (5, shifted.shape[0] * shifted.shape[1])
    num = int(got.num)
    assert num > 0
    if name == "overlap":
        assert ((pid >= 0).sum(0) > 1).any(), "no point in two classes' proposals"
        assert not (pid[4] >= 0).any(), "class 6 passed min_npoint"
        assert num < 64
    if name == "truncate":
        assert num == 5
        assert (got.cls.numpy() == np.sort(got.cls.numpy())).all()       # class-major
    if name == "tiny":
        assert not got.valid.numpy()[num:].any()
    if name == "batchwide":
        assert (pid[4] >= 0).any(), "class 6 was skipped"


def test_radius_neighbor_mask_matches_jax(soft_case):
    _, shifted, _, _, _ = soft_case
    coords = shifted.reshape(-1, 3)
    bid = np.repeat(np.arange(shifted.shape[0], dtype=np.int32), shifted.shape[1])
    for ids in (None, bid):
        want = jgrouping.radius_neighbor_mask(jnp.asarray(coords), 0.03,
                                              None if ids is None else jnp.asarray(ids))
        got = tgrouping.radius_neighbor_mask(torch.from_numpy(coords), 0.03,
                                             None if ids is None else torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _head_outputs(pid, p, seed):
    rng = np.random.default_rng(seed)
    cls_scores = rng.standard_normal((p, C)).astype(np.float32)
    cls_scores[np.arange(p), rng.integers(0, C, p)] += 6.0
    iou = rng.uniform(-0.2, 1.2, (p, C)).astype(np.float32)
    mask = rng.normal(0.0, 3.0, (*pid.shape, C)).astype(np.float32)
    return cls_scores, iou, mask


@pytest.mark.parametrize("min_npoint", [3, 150])
def test_instance_masks_and_bits_match_jax(soft_case, min_npoint):
    _, shifted, _, props, _ = soft_case
    pid, valid, batch = props.point_pid.numpy(), props.valid.numpy(), props.batch.numpy()
    p = valid.shape[0]
    args = (pid, *_head_outputs(pid, p, 1), valid)
    want = [np.asarray(w) for w in
            jinst.instance_masks_device(*map(jnp.asarray, args), C, min_npoint=min_npoint)]
    got = [g.numpy() for g in
           tinst.instance_masks_device(*map(torch.from_numpy, args), C, min_npoint=min_npoint)]
    for name, g, w in zip(("keep", "conf", "npoint", "masks"), got, want):
        if name == "conf":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    keep, conf, npoint, masks = got
    if min_npoint == 3:
        assert keep.any()
    if not valid.all():                       # empty proposal slots hold empty masks
        assert not masks[~valid].any() and not keep[~valid].any()

    n_total = pid.shape[1]
    bits = tinst.pack_mask_bits(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(bits, np.asarray(jinst.pack_mask_bits(jnp.asarray(masks))))
    np.testing.assert_array_equal(tinst.unpack_mask_bits(bits, n_total), masks)
    b, n = shifted.shape[:2]
    for bi in range(b):
        kw = dict(prop_mask=batch == bi, label_offset=2)
        sl = slice(bi * n, (bi + 1) * n)
        assert tinst.instances_from_masks(keep, conf, npoint, masks[:, sl], **kw) == \
            jinst.instances_from_masks(keep, conf, npoint, masks[:, sl], **kw)


@pytest.mark.parametrize("n", [8, 13, 1])
def test_mask_bits_roundtrip_odd_lengths(n):
    masks = np.random.default_rng(n).random((3, n, 4)) < 0.4
    bits = tinst.pack_mask_bits(torch.from_numpy(masks)).numpy()
    assert bits.shape == (3, 4, -(-n // 8)) and bits.dtype == np.uint8
    np.testing.assert_array_equal(bits, np.asarray(jinst.pack_mask_bits(jnp.asarray(masks))))
    np.testing.assert_array_equal(tinst.unpack_mask_bits(bits, n), masks)
