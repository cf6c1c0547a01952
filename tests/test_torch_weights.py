"""Weight bridge of the PyTorch port (gcanet_tpu_torch/utils/from_jax.py):
a flax tree converted directly must equal the same tree exported by
``import_torch.export_state_dict`` and loaded through the reference-format
loader; a ``checkpoint_eval{N}.tar`` written by ``save_reference_checkpoint``
loads with nothing missing; and the transposed conv's spatial flip is
checked by running one ``ConvTranspose`` on both sides."""

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
from gcanet_tpu_torch.utils import from_jax

torch.set_num_threads(1)

# parameter shapes do not depend on N; KPAM's k x k needs the default offset_knn
SMALL = dict(num_points=128, nn_nb=8, nn_nb_inner=4, knn_impl="xla")


@pytest.fixture(scope="module")
def jax_tree():
    model = JPrimitiveNet(JConfig(**SMALL))
    z = jnp.zeros((1, 128, 3))
    v = jax.jit(lambda r: model.init({"params": r}, z, z, train=True, rng=r))(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: (np.asarray(a) + rng.uniform(0.1, 1.0, a.shape))
                         .astype(np.float32), v["batch_stats"])
    return jax.tree.map(np.asarray, v["params"]), stats


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
