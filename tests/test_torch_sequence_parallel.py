"""Sequence parallelism of the port against the JAX package on the 8-device
virtual CPU mesh of ``tests/conftest.py``: ring kNN and ring gather
(``parallel/sharded_knn.py``), the sharded trunk
(``parallel/sharded_encoder.py``), ``Predictor.predict_type_sharded`` and
``serve_http``'s ``/v1/predict_type_sharded``.  The port's shards are
``["cpu"] * d``: one process, the ring's arithmetic tile by tile.

Tolerances: neighbour sets by their sorted distances at atol 1e-4 (ties
may reorder indices; ``tests/test_sharded_knn.py``'s rule); the trunk's
and the predictor's floats at rtol = atol = 2e-4
(``tests/test_sharded_encoder.py``'s: the one-pass sharded GroupNorm and
the tile order differ from the unsharded program); ``types`` exactly, on a
cloud whose type scores hold no gap below 1e-4 (checked); the ring gather
exactly.  The weights are seeded numpy draws into the shapes of the JAX
tree (``jax.eval_shape``: no JAX init runs).
"""

import ast
import functools
import inspect
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.models.primitive_net import PrimitiveNet as JPrimitiveNet
from gcanet_tpu.parallel import sharded_encoder as jse
from gcanet_tpu.parallel import sharded_knn as jsk
from gcanet_tpu.serve import Predictor as JPredictor
from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.parallel import sharded_encoder, sharded_knn
from gcanet_tpu_torch.parallel.sharded_knn import ring_gather, ring_knn, shard_rows
from gcanet_tpu_torch.serve import Predictor, ScenePredictor
from gcanet_tpu_torch.serve_http import PredictionServer
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

DIST = dict(atol=1e-4, rtol=0)
FLOAT = dict(rtol=2e-4, atol=2e-4)
TYPE_GAP = 1e-4
BIG_N = 512                     # the predictor's cloud: 4x its config's 128 points


def _cfg_kw(n=256, k=12):
    return dict(num_points=n, batch_size=1, nn_nb=k, knn_impl="xla", offset_knn=6,
                offset_keypoints=16, max_instances=8)


def _jcfg(n=256):
    return JConfig(**_cfg_kw(n), grouping=JGroupingConfig(radius=0.1, min_npoint=5,
                                                          cc_max_iters=8),
                   instance_head=JIHConfig(grid_size=8, max_proposals=8))


def _tcfg(n=256, **kw):
    return Config(**_cfg_kw(n), grouping=GroupingConfig(radius=0.1, min_npoint=5,
                                                        cc_max_iters=8),
                  instance_head=InstanceHeadConfig(grid_size=8, max_proposals=8)).replace(**kw)


def _mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("data",))


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return xyz, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def weights():
    """The JAX flagship's trees (shapes by ``eval_shape``) filled from a
    numpy seed: kernels N(0, 1/fan_in), scales U(0.8, 1.2), variances
    U(0.5, 1.5), the rest U(-0.1, 0.1)."""
    z = jnp.zeros((1, 256, 3))
    shapes = jax.eval_shape(lambda r: JPrimitiveNet(_jcfg()).init(
        {"params": r}, z, z, train=False, rng=r), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    return params, stats


@pytest.fixture(scope="module")
def trunk(weights):
    """One N=256 cloud, the JAX unsharded forward on it, and the port's
    model from the same weights."""
    params, stats = weights
    xyz, nrm = _cloud(256, seed=1)
    out = jax.jit(lambda v, a, b: JPrimitiveNet(_jcfg()).apply(
        v, a, b, train=False, rng=jax.random.PRNGKey(2)))(
        {"params": params, "batch_stats": stats}, xyz[None], nrm[None])
    want = [np.asarray(t)[0] for t in (out.type_per_point, out.param_per_point,
                                       out.embedding)]
    model = PrimitiveNet(_tcfg())
    model.load_state_dict(state_dict_from_jax(params, stats), strict=False)
    return np.concatenate([xyz, nrm], -1), want, model.eval()


def _np_dist(x, metric):
    if metric == "posnormal":
        p, n = x[:, :3].astype(np.float64), x[:, 3:].astype(np.float64)
        pd = ((p[:, None] - p[None]) ** 2).sum(-1)
        return pd * (1.0 + 2.0 - 2.0 * n @ n.T)
    x = x.astype(np.float64)
    return ((x[:, None] - x[None]) ** 2).sum(-1)


def _dist_set(dist, idx):
    return np.sort(np.take_along_axis(dist, np.asarray(idx), axis=1), axis=1)


@pytest.mark.parametrize("metric", ["euclid", "posnormal"])
@pytest.mark.parametrize("d", [8, 2])
def test_ring_knn_matches_jax_and_unsharded(d, metric):
    n, k = 64 * 8, 7
    if metric == "euclid":
        x = np.random.RandomState(0).randn(n, 8).astype(np.float32)
        port_metric, jmetric, unsharded = None, None, knn_ops.knn_indices
    else:
        x = np.concatenate(_cloud(n, seed=0), -1)
        port_metric, jmetric = sharded_encoder.posnormal_metric, jse.posnormal_metric
        unsharded = knn_ops.knn_points_normals_indices
    mesh = _mesh(d)
    jfn = jax.jit(jax.shard_map(
        functools.partial(jsk.ring_knn_local, k=k, d=d, axis="data", metric=jmetric),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False))
    jidx = np.asarray(jfn(jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))))
    got = sharded_knn.sharded_knn(torch.from_numpy(x), k, ["cpu"] * d, port_metric)
    assert got.shape == (n, k) and got.dtype == torch.int64
    one = unsharded(torch.from_numpy(x)[None], k)[0]
    dist = _np_dist(x, metric)
    want = _dist_set(dist, jidx)
    np.testing.assert_allclose(_dist_set(dist, got), want, **DIST)
    np.testing.assert_allclose(_dist_set(dist, one), want, **DIST)
    # per shard: global indices, nearest first
    shards = ring_knn([t for t in torch.from_numpy(x).chunk(d)], k, port_metric)
    assert torch.equal(torch.cat(shards), got)
    picked = np.take_along_axis(dist, got.numpy(), axis=1)
    assert (np.diff(picked, axis=1) >= -1e-4).all()


@pytest.mark.parametrize("d", [8, 2])
def test_ring_gather_matches_indexing(d):
    rng = np.random.default_rng(d)
    n = 64 * 8
    vals = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    gidx = torch.from_numpy(rng.integers(0, n, (n, 9)))
    got = ring_gather(list(vals.chunk(d)), list(gidx.chunk(d)))
    assert torch.equal(torch.cat(got), vals[gidx])


@pytest.mark.parametrize("d", [8, 2])
def test_sharded_trunk_matches_jax(weights, trunk, d):
    params, _ = weights
    x6, want_apply, model = trunk
    mesh = _mesh(d)
    jx = jax.device_put(jnp.asarray(x6), NamedSharding(mesh, P("data")))
    want_sharded = [np.asarray(t) for t in jse.make_sharded_type_fn(_jcfg(), mesh)(params, jx)]
    got = sharded_encoder.sharded_type_forward([model] * d,
                                               shard_rows(torch.from_numpy(x6), ["cpu"] * d))
    for name, g, ws, wa in zip(("type_per_point", "param_per_point", "embedding"), got,
                               want_sharded, want_apply):
        g = torch.cat(g).numpy()
        assert g.shape == wa.shape, name
        np.testing.assert_allclose(g, ws, **FLOAT, err_msg=f"{name} vs the JAX sharded trunk")
        np.testing.assert_allclose(g, wa, **FLOAT, err_msg=f"{name} vs JAX PrimitiveNet.apply")


def test_predictor_matches_jax(weights):
    params, stats = weights
    xyz, nrm = _cloud(BIG_N, seed=3)
    # the JAX Predictor around these weights, without its own initialisation;
    # no mesh: it shards over every local device (8)
    jpred = object.__new__(JPredictor)
    jpred.cfg, jpred.mesh = _jcfg(128), None
    jpred.state = type("State", (), {"params": params, "batch_stats": stats})
    want = jpred.predict_type_sharded(xyz, nrm)
    top2 = np.sort(want["type_per_point"], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > TYPE_GAP      # no near-tie to flip an argmax

    sd = state_dict_from_jax(params, stats)
    for d in (8, 1):
        cfg = _tcfg(128, mesh_shape=str(d))
        pred = Predictor(cfg, sd, device=["cpu"] * d if d > 1 else "cpu")
        got = pred.predict_type_sharded(xyz, nrm)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["types"], want["types"])
        for key in ("type_per_point", "param_per_point", "embedding"):
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32, key
            np.testing.assert_allclose(got[key], want[key], **FLOAT, err_msg=f"{key} d={d}")


def test_refusals():
    x6 = torch.from_numpy(np.concatenate(_cloud(256, seed=4), -1))
    for kw in (dict(mode=3), dict(shared_graph=True)):
        model = PrimitiveNet(_tcfg(**kw)).eval()
        with pytest.raises(ValueError, match="mode 5 without shared_graph"):
            sharded_encoder.sharded_type_forward([model] * 2, shard_rows(x6, ["cpu"] * 2))
    pred = Predictor(_tcfg(mesh_shape="8"), device=["cpu"] * 8)
    xyz, nrm = _cloud(100, seed=4)
    with pytest.raises(ValueError, match="N=100 points do not shard over 8 devices"):
        pred.predict_type_sharded(xyz, nrm)
    with pytest.raises(ValueError, match=r"\[N, 3\] with equal N"):
        pred.predict_type_sharded(xyz, nrm[:96])
    with pytest.raises(ValueError, match="equal numbers of points"):
        ring_knn([x6[:8], x6[:16]], 4)
    # the scene family has no sharded trunk (the JAX ScenePredictor neither)
    assert not hasattr(ScenePredictor, "predict_type_sharded")
    if not torch.cuda.is_available():              # a listed card that is absent
        with pytest.raises(RuntimeError, match="cuda"):
            Predictor(_tcfg(mesh_shape="2"), device=["cuda:0", "cuda:1"])


def test_ring_enqueues_without_host_sync():
    """No call in the ring's code reads a device value on the host, so the
    shards' work overlaps on several cards (on the card
    ``tests/test_torch_cuda.py`` runs it under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    host_reads = {"item", "cpu", "tolist", "numpy", "any", "all", "nonzero", "equal",
                  "synchronize", "bool"}
    for module in (sharded_knn, sharded_encoder):
        calls = [node.func for node in ast.walk(ast.parse(inspect.getsource(module)))
                 if isinstance(node, ast.Call)]
        names = {getattr(f, "attr", getattr(f, "id", None)) for f in calls}
        assert len(calls) > 20 and not names & host_reads, (module.__name__,
                                                             names & host_reads)


def _post(srv, body, ctype="application/json", accept=""):
    return srv.handle("/v1/predict_type_sharded", body, ctype, accept)


def test_http_route(weights):
    params, stats = weights
    srv = PredictionServer(_tcfg(128, mesh_shape="2"), state_dict_from_jax(params, stats),
                           device=["cpu", "cpu"])
    try:
        xyz, nrm = _cloud(BIG_N, seed=3)
        want = srv.predictor.predict_type_sharded(xyz, nrm)
        body = json.dumps({"xyz": xyz.tolist(), "normals": nrm.tolist()}).encode()
        status, ctype, payload = _post(srv, body)
        assert (status, ctype) == (200, "application/json"), payload
        assert json.loads(payload) == {"types": want["types"].tolist()}
        buf = io.BytesIO()
        np.savez(buf, xyz=xyz, normals=nrm)
        status, ctype, payload = _post(srv, buf.getvalue(), "application/x-npz",
                                       "application/x-npz")
        assert (status, ctype) == (200, "application/x-npz")
        with np.load(io.BytesIO(payload)) as z:
            assert sorted(z.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(z[k], v, err_msg=k)
        for bad, what in (({"xyz": xyz[:, :2], "normals": nrm[:, :2]}, "[N, 3]"),
                          ({"xyz": xyz, "normals": nrm[:256]}, "equal N"),
                          ({"xyz": xyz[:255], "normals": nrm[:255]}, "multiple of the device")):
            status, _, payload = _post(srv, json.dumps(
                {k: v.tolist() for k, v in bad.items()}).encode())
            assert status == 400 and what in json.loads(payload)["error"], payload
    finally:
        srv.batcher.close()
    # a call that raises answers 500: the mode-3 trunk is not sharded
    srv = PredictionServer(_tcfg(128, mode=3), device="cpu")
    try:
        status, _, payload = _post(srv, body)
        assert status == 500 and "mode 5" in json.loads(payload)["error"]
    finally:
        srv.batcher.close()
