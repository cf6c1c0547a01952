"""The flagship's serving extras in the PyTorch port against the JAX package:
the set-aggregation absorb caps of ``--strict_caps``, ``panoptic_fusion``,
``Predictor.predict(return_masks=True, panoptic=True)``, the proposal-rank
guards, and the HTTP front-end ``serve_http`` (on port 0, on the CPU).

Tolerances: grouping, instances, labels and panoptic labels exact; the
HTTP responses equal ``Predictor.predict`` on the same cloud (integers and
masks exact, ``conf`` rtol 1e-5), with a proposal cap no batch of the test
reaches (a batch's proposals share the cap).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_grouping_caps import _absorb_scene

from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.ops.grouping import build_proposals as jbuild_proposals
from gcanet_tpu.train import instances as jinst
from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_clouds, synth_scene_batch
from gcanet_tpu_torch.ops import grouping as tgrouping
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.serve_http import DynamicBatcher, PredictionServer
from gcanet_tpu_torch.train import instances as tinst
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 1024
SMALL = dict(batch_size=2, nn_nb=12, nn_nb_inner=8, offset_knn=6, offset_keypoints=24,
             knn_impl="xla")
GROUP = dict(similarity_threshold_inst=0.9, class_numpoint_mean=(-1.0,) * 7, min_npoint=20)
# the server's: 512 points, 16-wide embedding and head, and a proposal cap
# no batch of two clouds of the test reaches, so a cloud's result does not
# depend on the cloud batched with it
SERVER_N, SERVER_PROPOSALS = 512, 32


def _cfg(n=N, radius=0.05, max_proposals=24, width=64):
    """``width``: the embedding's, which is the instance head's."""
    return Config(num_points=n, **SMALL, out_dim=width,
                  grouping=GroupingConfig(radius=radius, **GROUP),
                  instance_head=InstanceHeadConfig(grid_size=8, max_proposals=max_proposals,
                                                   channels=width))


def _push(model):
    """Proposals pass the instance thresholds (as ``chip_smoke.push_weights``)."""
    with torch.no_grad():
        model.offset_pred_block.mlp_offset.weight.mul_(0.05)
        model.cls_linear.bias[0] += 10.0
        model.mask_linear[2].bias += 10.0


@pytest.fixture(scope="module")
def predictor():
    pred = Predictor(_cfg(), device="cpu")
    _push(pred.model)
    return pred


# ---------------------------------------------------------------- grouping


@pytest.mark.parametrize("frag_cap,point_cap", [(2, 3000), (1000, 5), (3, 6)])
def test_absorb_caps_match_jax(frag_cap, point_cap):
    """tests/test_grouping_caps.py's absorb scene (one primary, six
    fragments in its set-aggregation radius): the fragment cap, the point
    cap and both bite, exactly as in the JAX package."""
    xyz, cls, _, _, emb, param, mean_tbl = _absorb_scene()
    kw = dict(absorb_fragment_cap=frag_cap, absorb_point_cap=point_cap,
              class_numpoint_mean=tuple(mean_tbl))
    jcfg = JGroupingConfig(**kw)
    want = jax.jit(lambda *a: jbuild_proposals(*a, num_classes=7, cfg=jcfg, max_proposals=16,
                                                using_set_aggr=True))(
        jnp.asarray(xyz), jnp.asarray(cls, jnp.int32), jnp.asarray(emb), jnp.asarray(param))
    got = tgrouping.build_proposals(
        torch.from_numpy(xyz), torch.from_numpy(cls).to(torch.int32), torch.from_numpy(emb),
        torch.from_numpy(param), num_classes=7, cfg=GroupingConfig(**kw), max_proposals=16,
        using_set_aggr=True)
    absorbed = int((got.point_pid[1] >= 0).sum())
    assert 0 < absorbed < 24, absorbed               # a cap bit
    for field, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


def test_rank_guards_refuse_at_the_sentinel():
    """A rank at or above 2**30 (the sentinel of "no proposal") is refused,
    before anything is allocated (meta tensors); the largest shipped shapes
    pass."""
    two30 = 2**30
    for bound in (tgrouping.proposal_rank_bound(3, 7000, 7),       # flagship training
                  tgrouping.proposal_rank_bound(10, 8192, 7),      # the bench
                  tgrouping.soft_rank_bound(8, 8192, 18)):         # scene, 18 grouped
        assert bound < two30
        tgrouping.check_rank_bound(bound, "shipped shape")
    assert tgrouping.proposal_rank_bound(3, 7000, 7) == 923_999
    assert tgrouping.soft_rank_bound(8, 8192, 18) == 1_245_184
    with pytest.raises(ValueError, match="sentinel"):
        tgrouping.check_rank_bound(two30, "at the sentinel")

    n = 2**26 + 1                      # flagship bound 16 n - 1: in [2**30, 2**31)
    assert two30 <= tgrouping.proposal_rank_bound(1, n, 7) < 2**31
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="sentinel"):
        tgrouping.build_proposals(torch.empty(1, n, 3, **meta),
                                  torch.empty(1, n, dtype=torch.int32, **meta),
                                  torch.empty(1, n, 8, **meta), torch.empty(1, n, 22, **meta),
                                  7, GroupingConfig(), max_proposals=100)
    n = 357_913_942                    # soft bound 3 n with 2 classes: in [2**30, 2**31)
    assert two30 <= tgrouping.soft_rank_bound(1, n, 2) < 2**31
    with pytest.raises(ValueError, match="sentinel"):
        tgrouping.build_soft_proposals(torch.empty(1, n, 3, **meta),
                                       torch.empty(1, n, 2, **meta), 2,
                                       GroupingConfig(), max_proposals=100)


# ---------------------------------------------------------------- instances


def _random_instances(rng, n, count):
    out = []
    for _ in range(count):
        mask = rng.random(n) < rng.uniform(0.05, 0.5)
        out.append({"label_id": int(rng.integers(1, 14)), "conf": float(rng.random()),
                    "pred_mask": tinst.rle_encode(mask)})
    return out


def test_panoptic_fusion_matches_jax():
    rng = np.random.default_rng(0)
    for trial in range(5):
        n = 300
        sem = rng.integers(0, 14, n)
        insts = _random_instances(rng, n, int(rng.integers(0, 8)))
        got = tinst.panoptic_fusion(sem, insts, 13)
        want = jinst.panoptic_fusion(sem, insts, 13)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_predict_masks_and_panoptic_match_jax_host_functions(predictor):
    """``return_masks``: the port's fetched arrays through the JAX package's
    ``get_instances`` / ``merge_masks`` / ``panoptic_fusion`` give the
    port's instances, labels and panoptic labels; the fast path's
    ``panoptic`` likewise."""
    xyz, nrm = synth_clouds(predictor.cfg, 1, seed=4)
    res = predictor.predict(xyz[0], nrm[0], return_masks=True, panoptic=True)
    pid, sem, cls_s, iou_s, mask_s, valid, tpp, ppp, off, emb = \
        predictor._forward_masks(xyz[0], nrm[0])
    want = jinst.get_instances(pid, sem, cls_s, iou_s, mask_s, valid, 7)
    assert want, "no instance"
    assert res["instances"] == want
    np.testing.assert_array_equal(res["instance_labels"], jinst.merge_masks(want))
    np.testing.assert_array_equal(res["panoptic"],
                                  jinst.panoptic_fusion(tpp.argmax(-1), want, 7))
    for key, value in (("type_per_point", tpp), ("param_per_point", ppp),
                       ("pt_offsets", off), ("embedding", emb)):
        np.testing.assert_array_equal(res[key], value, err_msg=key)

    fast = predictor.predict(xyz[0], nrm[0], panoptic=True)
    assert fast["instances"]
    np.testing.assert_array_equal(
        fast["panoptic"], jinst.panoptic_fusion(fast["type_per_point"].argmax(-1),
                                                fast["instances"], 7))


# ---------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def server():
    """A flagship server, its predictor's weights pushed; a 200 ms batching
    window, so two concurrent requests share one ``predict_batch``."""
    srv = PredictionServer(_cfg(SERVER_N, 0.1, SERVER_PROPOSALS, width=16), family="abc",
                           max_wait_ms=200.0, device="cpu")
    _push(srv.predictor.model)
    ready = threading.Event()
    thread = threading.Thread(target=srv.serve, kwargs=dict(host="127.0.0.1", port=0,
                                                            ready_event=ready), daemon=True)
    thread.start()
    assert ready.wait(30)
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    thread.join(30)
    assert not thread.is_alive() and not srv.batcher._thread.is_alive()


def _post(url, body, content_type="application/json", accept=""):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", content_type)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json_body(xyz, nrm):
    return json.dumps({"xyz": xyz.tolist(), "normals": nrm.tolist()}).encode()


def _proposals(predictor, xyz, nrm) -> int:
    with torch.inference_mode():
        return int(predictor.model(torch.from_numpy(xyz[None]), torch.from_numpy(nrm[None]))
                   .proposals.num)


def _assert_fits(predictor, xyz, nrm):
    """The two clouds of a batch (a cloud alone is batched with a copy of
    itself) hold fewer proposals than the cap, so none is truncated."""
    nums = [_proposals(predictor, xyz[i], nrm[i]) for i in range(len(xyz))]
    assert 2 * max(nums) <= SERVER_PROPOSALS and sum(nums) <= SERVER_PROPOSALS, nums


def _assert_equals_predict(got: dict, want: dict):
    assert got["types"] == want["type_per_point"].argmax(-1).tolist()
    assert got["instance_labels"] == want["instance_labels"].tolist()
    assert len(got["instances"]) == len(want["instances"])
    for g, w in zip(got["instances"], want["instances"]):
        assert (g["label_id"], g["npoint"], g["pred_mask"]) == \
            (w["label_id"], w["npoint"], w["pred_mask"])
        np.testing.assert_allclose(g["conf"], w["conf"], rtol=1e-5)


def test_healthz_and_unported_route(server):
    srv, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "family": "abc",
                                        "num_points": SERVER_N, "batch_size": 2}
    # the sequence-parallel route over the server's one device: a cloud of
    # twice num_points, the direct call's types; a bad shape answers 400
    xyz, nrm = synth_clouds(srv.predictor.cfg, 2, seed=6)
    xyz, nrm = xyz.reshape(-1, 3), nrm.reshape(-1, 3)
    status, ctype, payload = _post(base + "/v1/predict_type_sharded", _json_body(xyz, nrm))
    assert status == 200 and ctype == "application/json", payload
    want = srv.predictor.predict_type_sharded(xyz, nrm)["types"]
    assert json.loads(payload) == {"types": want.tolist()}
    status, ctype, payload = _post(base + "/v1/predict_type_sharded",
                                   _json_body(xyz, nrm[:SERVER_N]))
    assert status == 400 and ctype == "application/json"
    assert "equal N" in json.loads(payload)["error"]
    status, _, _ = _post(base + "/v1/no_such_route", b"{}")
    assert status == 404


def test_json_and_npz_round_trips_equal_predict(server):
    srv, base = server
    predictor = srv.predictor
    xyz, nrm = synth_clouds(predictor.cfg, 2, seed=5)
    _assert_fits(predictor, xyz, nrm)
    want = [predictor.predict(xyz[i], nrm[i]) for i in range(2)]
    assert any(w["instances"] for w in want)
    status, _, payload = _post(base + "/v1/predict", _json_body(xyz[0], nrm[0]))
    assert status == 200, payload
    _assert_equals_predict(json.loads(payload), want[0])

    buf = io.BytesIO()
    np.savez(buf, xyz=xyz[1], normals=nrm[1])
    status, ctype, payload = _post(base + "/v1/predict", buf.getvalue(),
                                   content_type="application/x-npz", accept="application/x-npz")
    assert status == 200 and "npz" in ctype
    with np.load(io.BytesIO(payload)) as z:
        for key in ("type_per_point", "param_per_point", "instance_labels"):
            np.testing.assert_array_equal(z[key], want[1][key], err_msg=key)
        np.testing.assert_array_equal(z["pt_offsets"], want[1]["pt_offsets"])
        insts = json.loads(bytes(z["instances_json"]).decode())
    assert [i["pred_mask"] for i in insts] == [w["pred_mask"] for w in want[1]["instances"]]


def test_batch_route_shape_errors_and_the_server_survives(server):
    srv, base = server
    predictor = srv.predictor
    xyz, nrm = synth_clouds(predictor.cfg, 2, seed=6)
    _assert_fits(predictor, xyz, nrm)
    buf = io.BytesIO()
    np.savez(buf, xyz=xyz, normals=nrm)
    status, _, payload = _post(base + "/v1/predict_batch", buf.getvalue(),
                               content_type="application/x-npz")
    assert status == 200, payload
    for got, want in zip(json.loads(payload), predictor.predict_batch(xyz, nrm)):
        _assert_equals_predict(got, want)

    bad = [(_json_body(xyz[0][:7], nrm[0][:7]), "xyz must be"),
           (_json_body(xyz[0], nrm[0][: SERVER_N // 2]), "'normals' must be"),
           (b"{}", "needs 'xyz'")]
    for body, message in bad:
        status, _, payload = _post(base + "/v1/predict", body)
        assert status == 400 and message in json.loads(payload)["error"]
    buf = io.BytesIO()
    np.savez(buf, xyz=xyz, normals=np.zeros((2, SERVER_N, 4), np.float32))
    status, _, _ = _post(base + "/v1/predict_batch", buf.getvalue(),
                         content_type="application/x-npz")
    assert status == 400
    assert _post(base + "/v1/nope", b"{}")[0] == 404
    status, _, payload = _post(base + "/v1/predict", _json_body(xyz[0], nrm[0]))
    assert status == 200, payload


def test_concurrent_requests_share_one_batch(server, monkeypatch):
    srv, base = server
    predictor = srv.predictor
    calls = []
    real = srv.batcher._fn
    monkeypatch.setattr(srv.batcher, "_fn", lambda a, b: calls.append(len(a)) or real(a, b))
    xyz, nrm = synth_clouds(predictor.cfg, 2, seed=7)
    _assert_fits(predictor, xyz, nrm)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, _post(base + "/v1/predict", _json_body(xyz[i], nrm[i])))) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert calls == [2], calls
    for i in range(2):
        status, _, payload = results[i]
        assert status == 200, payload
        _assert_equals_predict(json.loads(payload), predictor.predict(xyz[i], nrm[i]))


def test_batcher_failure_reaches_every_waiter():
    calls = []

    def flaky(xyz, aux):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fell over")
        return [{"ok": True} for _ in range(xyz.shape[0])]

    b = DynamicBatcher(flaky, batch_size=2, max_wait_ms=1.0, submit_timeout_s=30.0)
    try:
        one = np.zeros((4, 3), np.float32)
        with pytest.raises(RuntimeError, match="fell over"):
            b.submit(one, one)
        assert b.submit(one, one) == {"ok": True}
        slots = [({}, threading.Event()) for _ in range(2)]
        b._q.put((one, np.zeros((3, 3), np.float32), *slots[0]))   # ragged: stack fails
        b._q.put((one, one, *slots[1]))
        assert all(done.wait(30) for _, done in slots)
        assert all("error" in slot for slot, _ in slots)
        assert b.submit(one, one) == {"ok": True}
    finally:
        b.close()
    assert not b._thread.is_alive()


def test_scene_family_route():
    cfg = Config(num_points=128, batch_size=2, num_primitives=20,
                 instance_head=InstanceHeadConfig(grid_size=8, max_proposals=16))
    srv = PredictionServer(cfg, family="scene", max_wait_ms=5.0, device="cpu", scene_grid=8)
    try:
        batch = synth_scene_batch(cfg, 1, seed=3)
        xyz, feats = (np.asarray(batch[k][0], np.float32) for k in ("xyz", "feats"))
        body = json.dumps({"xyz": xyz.tolist(), "feats": feats.tolist()}).encode()
        status, _, payload = srv.handle("/v1/predict", body, "application/json", "")
        assert status == 200, payload
        res = json.loads(payload)
        assert len(res["types"]) == len(res["instance_labels"]) == 128
        assert all(isinstance(t, int) for t in res["types"])
        status, _, payload = srv.handle("/v1/predict_type_sharded", body, "application/json", "")
        assert status == 400 and "abc family" in json.loads(payload)["error"]
    finally:
        srv.batcher.close()
