"""Losses and mask-IoU ops of the PyTorch port against the JAX package on the
same numpy inputs: every loss of ``losses/losses.py``, its gradient against
``jax.grad``, and ``mask_iou_on_cluster`` / ``mask_iou_on_pred`` /
``mask_label``.

Inputs are built so that every branch does work: background points and
out-of-table instance ids, parameter groups skipped for each of the
reference's rules, proposals overlapping instances above and below the
IoU threshold, absorbed entries in channel 1, empty proposals.  Rules:
integers and mask labels exact, IoUs exact (the same count ratios);
loss values at rtol 1e-5; gradients at rtol 1e-4 with atol 1e-6 (fp32
sums in another order).  All JAX work is one jit, shared by the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.losses import losses as JL
from gcanet_tpu.ops import mask_iou as jmiou
from gcanet_tpu_torch.losses import losses as TL
from gcanet_tpu_torch.ops import mask_iou as tmiou
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

B, N, E, K, C = 2, 96, 8, 7, 7
P, I_MAX = 12, 8
VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n_total = B * N
    d = {}
    # embedding: instance ids in [-1, I_MAX + 2) (ids >= I_MAX - 1 overflow)
    d["i_gt"] = rng.integers(-1, I_MAX + 2, (B, N)).astype(np.int32)
    d["i_gt"][1, :] = np.where(rng.random(N) < 0.5, 3, -1)   # item 1: one center + bg
    d["feat"] = rng.standard_normal((B, N, E)).astype(np.float32)
    d["nrm_pred"] = rng.standard_normal((B, N, 3)).astype(np.float32)
    d["nrm_gt"] = rng.standard_normal((B, N, 3)).astype(np.float32)
    d["nrm_gt"][0, :4] = d["nrm_pred"][0, :4] * 5.0           # clamped dot products
    d["logp"] = np.asarray(jax.nn.log_softmax(rng.standard_normal((B, N, K)))).astype(np.float32)
    d["t_gt"] = rng.choice([-1, 0, 1, 3, 4, 5], (B, N)).astype(np.int32)
    # parameters: zero gt rows, a gt max above 10 (item 0 planes), an
    # MSE above 50 (item 1 cones), an all-zero group (item 1 spheres)
    d["param_pred"] = rng.standard_normal((B, N, 22)).astype(np.float32)
    t_param = rng.standard_normal((B, N, 22)).astype(np.float32)
    t_param[:, ::5] = 0.0
    t_param[0, d["t_gt"][0] == 1, 4:8] += 20.0
    d["param_pred"][1, d["t_gt"][1] == 3, 15:22] += 30.0
    t_param[1, d["t_gt"][1] == 5] = 0.0
    d["t_param"] = t_param
    # offsets and instances over the flattened batch
    inst = rng.integers(0, 6, n_total).astype(np.int32)
    inst[rng.random(n_total) < 0.15] = -1
    d["inst_labels"] = inst
    d["pt_offsets"] = rng.standard_normal((n_total, 3)).astype(np.float32)
    d["offset_lbl"] = rng.standard_normal((n_total, 3)).astype(np.float32)
    pointnum = np.zeros(I_MAX, np.int32)
    for j in range(6):
        pointnum[j] = (inst == j).sum()
    d["pointnum"] = pointnum
    d["inst_cls"] = np.array([1, 3, 0, 4, 5, 1, 0, 0], np.int32)   # id 2: background class
    d["inst_valid"] = np.arange(I_MAX) < 6
    # proposals: instance j -> proposal j (+ noise); 6..8 random; 9.. empty
    pid0 = np.where(inst >= 0, inst, rng.integers(6, 9, n_total))
    noise = rng.random(n_total)
    pid0 = np.where(noise < 0.1, rng.integers(0, 9, n_total), pid0)
    pid0 = np.where(noise > 0.95, -1, pid0)
    pid0[(inst == 4) & (rng.random(n_total) < 0.7)] = -1          # proposal 4 below IoU 0.5
    pid1 = np.where(rng.random(n_total) < 0.05, rng.integers(0, 9, n_total), -1)
    d["point_pid"] = np.stack([pid0, pid1]).astype(np.int32)
    d["prop_valid"] = np.arange(P) < 9
    d["cls_scores"] = rng.standard_normal((P, C)).astype(np.float32)
    d["iou_scores"] = rng.standard_normal((P, C)).astype(np.float32)
    d["mask_scores"] = (2 * rng.standard_normal((2, n_total, C))).astype(np.float32)
    d["mask_scores"][d["point_pid"] < 0] = 0.0
    return d


def _jax_all(d):
    """Every loss value and gradient of the JAX package, in one jit."""
    def emb(feat):
        return JL.compute_embedding_loss(feat, d["i_gt"], I_MAX)

    def inst(cls_s, mask_s, iou_s):
        return JL.instance_loss(cls_s, mask_s, iou_s, d["point_pid"], d["prop_valid"],
                                d["inst_labels"], d["pointnum"], d["inst_cls"],
                                d["inst_valid"], C)

    out = {}
    (out["emb"], out["emb_parts"]), out["emb_grad"] = jax.value_and_grad(
        lambda f: (emb(f)[0], emb(f)[1:]), has_aux=True)(d["feat"])
    out["normal"], out["normal_grad"] = jax.value_and_grad(JL.compute_normal_loss)(
        d["nrm_pred"], d["nrm_gt"])
    out["nnl"], out["nnl_grad"] = jax.value_and_grad(JL.compute_nnl_loss)(
        d["logp"], d["t_gt"])
    out["param"], out["param_grad"] = jax.value_and_grad(JL.compute_param_loss)(
        d["param_pred"], d["t_gt"], d["t_param"])
    out["offset"], out["offset_grad"] = jax.value_and_grad(JL.offset_loss)(
        d["pt_offsets"], d["inst_labels"], d["offset_lbl"])
    (out["inst"], out["inst_aux"]), out["inst_grad"] = jax.value_and_grad(
        inst, argnums=(0, 1, 2), has_aux=True)(d["cls_scores"], d["mask_scores"],
                                               d["iou_scores"])
    ious = jmiou.mask_iou_on_cluster(d["point_pid"], d["inst_labels"], d["pointnum"],
                                     P, I_MAX)
    sig = jax.nn.sigmoid(d["mask_scores"][..., 1])
    out["ious"] = ious
    out["ious_pred"] = jmiou.mask_iou_on_pred(d["point_pid"], d["inst_labels"],
                                              d["pointnum"], sig, P, I_MAX)
    inst_cls = jnp.where(d["inst_valid"], d["inst_cls"], -100)
    out["mask_label"] = jmiou.mask_label(d["point_pid"], d["inst_labels"], inst_cls,
                                         ious, 0.5)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = _inputs()
    want = once(tmp_path_factory, "losses_reference", lambda: jax.tree.map(
        np.asarray, jax.jit(_jax_all)(jax.tree.map(jnp.asarray, d))))
    return d, want


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _check_value_and_grad(got, grads, want, want_grads):
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUE)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


def test_embedding_loss(data):
    d, want = data
    feat = _t(d["feat"], True)
    loss, pull, push = TL.compute_embedding_loss(feat, _t(d["i_gt"]), I_MAX)
    loss.backward()
    _check_value_and_grad(loss, [feat.grad], want["emb"], [want["emb_grad"]])
    np.testing.assert_allclose([pull.item(), push.item()], want["emb_parts"], **VALUE)
    assert want["emb_parts"][1] > 0                 # item 0 pushes


def test_normal_and_nnl_losses(data):
    d, want = data
    pred = _t(d["nrm_pred"], True)
    loss = TL.compute_normal_loss(pred, _t(d["nrm_gt"]))
    loss.backward()
    _check_value_and_grad(loss, [pred.grad], want["normal"], [want["normal_grad"]])
    logp = _t(d["logp"], True)
    loss = TL.compute_nnl_loss(logp, _t(d["t_gt"]))
    loss.backward()
    _check_value_and_grad(loss, [logp.grad], want["nnl"], [want["nnl_grad"]])


def test_param_loss_skip_rules(data):
    d, want = data
    pred = _t(d["param_pred"], True)
    loss = TL.compute_param_loss(pred, _t(d["t_gt"]), _t(d["t_param"]))
    loss.backward()
    _check_value_and_grad(loss, [pred.grad], want["param"], [want["param_grad"]])
    # the skipped groups get no gradient: item 0 planes (gt max > 10), item 1
    # cones (MSE > 50) and spheres (gt all zero)
    g = pred.grad.numpy()
    assert not g[0][d["t_gt"][0] == 1].any() and not g[1][d["t_gt"][1] == 3].any()
    assert not g[1][d["t_gt"][1] == 5].any()
    assert g[0][d["t_gt"][0] == 4].any()            # a surviving group


def test_offset_loss(data):
    d, want = data
    off = _t(d["pt_offsets"], True)
    loss = TL.offset_loss(off, _t(d["inst_labels"]), _t(d["offset_lbl"]))
    loss.backward()
    _check_value_and_grad(loss, [off.grad], want["offset"], [want["offset_grad"]])


def test_instance_loss_and_aux(data):
    d, want = data
    scores = [_t(d[k], True) for k in ("cls_scores", "mask_scores", "iou_scores")]
    total, aux = TL.instance_loss(*scores, *map(_t, (
        d["point_pid"], d["prop_valid"], d["inst_labels"], d["pointnum"],
        d["inst_cls"], d["inst_valid"])), C)
    total.backward()
    _check_value_and_grad(total, [s.grad for s in scores], want["inst"], want["inst_grad"])
    for name, g, w in zip(TL.InstanceLossAux._fields, aux, want["inst_aux"]):
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=name, **VALUE)
    assert 0 < want["inst_aux"][3] < 9              # positive and negative proposals
    assert all(float(x.detach()) > 0 for x in aux[:3])


def test_mask_iou_and_mask_label_exact(data):
    d, want = data
    pid, lbl, num = _t(d["point_pid"]), _t(d["inst_labels"]), _t(d["pointnum"])
    ious = tmiou.mask_iou_on_cluster(pid, lbl, num, P, I_MAX)
    np.testing.assert_array_equal(ious.numpy(), want["ious"])
    sig = torch.sigmoid(_t(d["mask_scores"])[..., 1])
    np.testing.assert_array_equal(
        tmiou.mask_iou_on_pred(pid, lbl, num, sig, P, I_MAX).numpy(), want["ious_pred"])
    inst_cls = torch.where(_t(d["inst_valid"]), _t(d["inst_cls"]), -100)
    got = tmiou.mask_label(pid, lbl, inst_cls, ious, 0.5).numpy()
    np.testing.assert_array_equal(got, want["mask_label"])
    assert {-1.0, 0.0, 1.0} <= set(np.unique(got).tolist())
