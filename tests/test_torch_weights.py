"""Weight bridge of the PyTorch port (gcanet_tpu_torch/utils/from_jax.py):
a flax tree converted directly must equal the same tree exported by
``import_torch.export_state_dict`` and loaded through the reference-format
loader; a ``checkpoint_eval{N}.tar`` written by ``save_reference_checkpoint``
loads with nothing missing; and the transposed conv's spatial flip is
checked by running one ``ConvTranspose`` on both sides.  The port's writer
(``utils/reference_ckpt.py``) writes the JAX exporter's file from the same
weights, key for key and bit for bit, and reads back exactly.  The port's
copy of ``jax.random`` (``utils/threefry.py``) gives JAX's keys, bits and
uniforms exactly and its normals and truncated normals within 4 float32
units in the last place, and flax's draw of that ``ConvTranspose``'s kernel
(``utils/flax_init.py``)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.models.primitive_net import PrimitiveNet as JPrimitiveNet
from gcanet_tpu.utils import import_torch
from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.utils import flax_init, from_jax, reference_ckpt, threefry
from tests import torch_init_law as law
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

# parameter shapes do not depend on N; KPAM's k x k needs the default offset_knn
SMALL = dict(num_points=128, nn_nb=8, nn_nb_inner=4, knn_impl="xla")


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The JAX flagship's trees (shapes by ``jax.eval_shape``, nothing
    compiled) filled from a numpy seed: every check here is structural or
    bit for bit, so any values do.  Built once per session
    (``tests/torch_once.py``)."""
    return once(tmp_path_factory, "weights_jax_tree", _jax_tree)


def _jax_tree():
    z = jnp.zeros((1, 128, 3))
    shapes = jax.eval_shape(lambda r: JPrimitiveNet(JConfig(**SMALL)).init(
        {"params": r}, z, z, train=True, rng=r), jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)

    def fill(path, s):
        if path[-1].key == "kernel":
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            w = rng.uniform(0.1, 1.0, s.shape)
        return w.astype(np.float32)

    return tuple(jax.tree_util.tree_map_with_path(fill, shapes[k])
                 for k in ("params", "batch_stats"))


def _port_model():
    return PrimitiveNet(Config(**SMALL))


def test_direct_equals_export_then_load(jax_tree):
    params, stats = jax_tree
    direct = from_jax.state_dict_from_jax(params, stats)
    model = _port_model()
    assert set(direct) == set(model.state_dict())

    exported, ereport = import_torch.export_state_dict(params, stats)
    assert not ereport.missing
    assert {k[len("affinitynet."):] for k in ereport.mapped} == set(direct)
    report = from_jax.load_reference_checkpoint(model, exported)
    assert report.missing == []
    loaded = model.state_dict()
    for key, want in direct.items():
        torch.testing.assert_close(loaded[key], want, rtol=0, atol=0, msg=key)


def test_reference_tar_loads(jax_tree, tmp_path):
    params, stats = jax_tree
    path = tmp_path / "checkpoint_eval3.tar"
    import_torch.save_reference_checkpoint(str(path), params, stats, epoch=3)
    model = _port_model()
    report = from_jax.load_reference_checkpoint(model, path)
    assert report.missing == []
    assert report.unexpected, "the reference format carries dead keys"
    for key in report.unexpected:
        assert any(s in key for s in from_jax.KNOWN_UNUSED), key
    direct = from_jax.state_dict_from_jax(params, stats)
    for key, want in direct.items():
        torch.testing.assert_close(model.state_dict()[key], want, rtol=0, atol=0, msg=key)


def test_loader_rejects_missing_keys(jax_tree):
    params, stats = jax_tree
    sd = from_jax.state_dict_from_jax(params, stats)
    del sd["cls_linear.weight"]
    with pytest.raises(ValueError, match="cls_linear.weight"):
        from_jax.load_reference_checkpoint(_port_model(), sd)


def test_deconv_flip_by_running_both():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 3, 3, 5)).astype(np.float32)        # [P, D, H, W, Cin]
    conv = fnn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])                 # [2, 2, 2, Cin, Cout]
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))           # [P, 6, 6, 6, Cout]

    def run(w):
        y = F.conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                               torch.from_numpy(np.ascontiguousarray(w)), stride=2)
        return y.permute(0, 2, 3, 4, 1).numpy()

    w = from_jax._from_flax(from_jax.DECONV3D, "weight", kernel)
    assert w.shape == (5, 4, 2, 2, 2)                                  # [in, out, k, k, k]
    np.testing.assert_allclose(run(w), want, rtol=1e-5, atol=1e-6)
    unflipped = kernel.transpose(3, 4, 0, 1, 2)
    assert not np.allclose(run(unflipped), want, atol=1e-3)
    # flax's own draw of the kernel: the root scope's first parameter
    assert law.ulps(flax_init._draw(0, (), 1, kernel.shape, "lecun"), kernel) <= law.MAX_ULPS
    _check_threefry()


def _check_threefry():
    """``utils/threefry.py`` against ``jax.random`` on several keys and
    shapes, one of over 2**16 elements."""
    for seed in (0, 7919 * 3 + 2, 2**31 - 1):
        k, jk = threefry.key(seed), jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(k, np.asarray(jk))
        for data in (1, 2**32 - 1):
            np.testing.assert_array_equal(threefry.fold_in(k, data),
                                          np.asarray(jax.random.fold_in(jk, data)))
        np.testing.assert_array_equal(threefry.split(k, 3), np.asarray(jax.random.split(jk, 3)))
    k, jk = threefry.fold_in(threefry.key(5), 9), jax.random.fold_in(jax.random.PRNGKey(5), 9)
    for shape in ((2, 3), (300, 257)):
        np.testing.assert_array_equal(threefry.random_bits(k, shape),
                                      np.asarray(jax.random.bits(jk, shape)))
        np.testing.assert_array_equal(threefry.uniform(k, shape),
                                      np.asarray(jax.random.uniform(jk, shape)))
        np.testing.assert_array_equal(threefry.uniform(k, shape, -0.5, 2.0),
                                      np.asarray(jax.random.uniform(jk, shape, minval=-0.5,
                                                                    maxval=2.0)))
        assert law.ulps(threefry.normal(k, shape),
                        np.asarray(jax.random.normal(jk, shape))) <= law.MAX_ULPS
        assert law.ulps(threefry.truncated_normal(k, -2.0, 2.0, shape), np.asarray(
            jax.random.truncated_normal(jk, -2.0, 2.0, shape))) <= law.MAX_ULPS


def _assert_same_file(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in ("epoch", "optimizer_state_dict"):
        assert got[key] == want[key], key
    g, w = got["model_state_dict"], want["model_state_dict"]
    assert list(g) == list(w)
    for key, t in w.items():
        assert g[key].dtype == t.dtype and g[key].shape == t.shape, key
        assert torch.equal(g[key], t), key


def test_writer_equals_jax_exporter(jax_tree, tmp_path):
    params, stats = jax_tree
    model = _port_model()
    model.load_state_dict(from_jax.state_dict_from_jax(params, stats))
    want_report = import_torch.save_reference_checkpoint(str(tmp_path / "jax.tar"), params,
                                                         stats, epoch=4)
    report = reference_ckpt.save_reference_checkpoint(str(tmp_path / "port.tar"), model,
                                                      epoch=4)
    assert (report.mapped, report.defaulted, report.missing) == \
        (want_report.mapped, want_report.defaulted, want_report.missing)
    assert report.missing == [] and len(report.defaulted) == 19
    _assert_same_file(*(torch.load(tmp_path / f, weights_only=True)
                        for f in ("port.tar", "jax.tar")))
    # the template holds every shape of the JAX package's synthetic checkpoint
    assert reference_ckpt.reference_template() == {
        k: np.shape(v) for k, v in import_torch.make_synthetic_state_dict().items()}


def test_writer_round_trip(jax_tree, tmp_path):
    params, stats = jax_tree
    model = _port_model()
    model.load_state_dict(from_jax.state_dict_from_jax(params, stats))
    path = tmp_path / "checkpoint_eval0.tar"
    reference_ckpt.save_reference_checkpoint(str(path), model)
    fresh = _port_model()
    report = from_jax.load_reference_checkpoint(fresh, path)
    assert report.missing == [] and report.skipped == report.unexpected
    want = model.state_dict()
    for key, t in fresh.state_dict().items():
        assert torch.equal(t, want[key]), key


def test_writer_refusals():
    from gcanet_tpu_torch.models.registry import build_model

    for kw in (dict(mode=3), dict(offset_variant="dual"), dict(ablation=True)):
        with pytest.raises(ValueError, match="mode-5 flagship"):
            reference_ckpt.export_reference_state_dict(PrimitiveNet(Config(**SMALL, **kw)))
    with pytest.raises(ValueError, match="PrimitiveNetSPP"):
        reference_ckpt.export_reference_state_dict(
            build_model(Config(**SMALL, model_dict="models.sppnet")))


def test_writer_cli(tmp_path, capsys):
    from gcanet_tpu_torch.train.trainer import Trainer

    report = reference_ckpt.main(["--selftest"])
    assert report.missing == [] and "selftest OK: 136 tensors" in capsys.readouterr().out
    cfg = Config(**SMALL, log_dir=str(tmp_path / "log"), data_path=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.save_checkpoint(2)
    finally:
        trainer.close()
    for name in ("train", "test"):        # the trainer's event files (tensorboardX imports here)
        assert list((tmp_path / "log" / "tb" / name).glob("events.out.tfevents.*")), name
    by_path = tmp_path / "a.tar"
    reference_ckpt.main(["--checkpoint", str(tmp_path / "log" / "checkpoint" / "latest.tar"),
                         "--out", str(by_path)])
    reference_ckpt.main(["--log_dir", cfg.log_dir, "--out", str(tmp_path / "b.tar")])
    assert "wrote" in capsys.readouterr().out
    got = torch.load(by_path, weights_only=True)
    assert got["epoch"] == 2
    _assert_same_file(torch.load(tmp_path / "b.tar", weights_only=True), got)
    fresh = _port_model()
    from_jax.load_reference_checkpoint(fresh, by_path)
    for key, t in trainer.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], t), key
