"""Connected components of the PyTorch port (gcanet_tpu_torch/ops/cc.py)
against the JAX package: the plain sweep against the Pallas kernel in
interpret mode, the CC loop against grouping.connected_components(xla) and a
BFS oracle.  Integer outputs, so every comparison is exact.  The CUDA
kernel itself is compared with the plain sweep on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.ops import cc_pallas
from gcanet_tpu.ops.grouping import connected_components as jax_cc
from gcanet_tpu_torch.ops import cc
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    a = np.triu(a, 1)
    return a | a.T                    # symmetric, zero diagonal


def _oracle_labels(a):
    n = a.shape[0]
    labels = -np.ones(n, np.int64)
    for i in range(n):
        if labels[i] >= 0:
            continue
        stack = [i]
        labels[i] = i
        while stack:
            cur = stack.pop()
            for j in np.nonzero(a[cur])[0]:
                if labels[j] < 0:
                    labels[j] = i
                    stack.append(j)
    return labels


@pytest.mark.parametrize("n,p,seed", [
    (10, 0.3, 0),
    (300, 0.02, 1),
    (257, 0.0, 2),      # no edges: identity labels
    (600, 0.02, 4),
    (2100, 0.005, 5),
])
def test_cc_matches_jax_and_oracle(n, p, seed):
    a = _random_graph(n, p, seed)
    got = cc.connected_components(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, _oracle_labels(a))
    np.testing.assert_array_equal(got, np.asarray(jax_cc(jnp.asarray(a), impl="xla")))


def test_cc_chain_worst_case():
    # 300-point chain: the adversarial depth for label propagation
    n = 300
    a = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    a[idx, idx + 1] = True
    a = a | a.T
    got = cc.connected_components(torch.from_numpy(a), max_iters=64).numpy()
    np.testing.assert_array_equal(got, np.zeros(n, np.int64))


@pytest.mark.parametrize("n,p", [(256, 0.01), (300, 0.05), (257, 0.0)])
def test_plain_sweep_matches_pallas_interpret(n, p):
    # the Pallas kernel takes a 256-multiple; compare on the valid block
    a = _random_graph(n, p, n)
    n_pad = -(-n // 256) * 256
    a_pad = np.zeros((n_pad, n_pad), np.int8)
    a_pad[:n, :n] = a
    labels = np.random.default_rng(n).permutation(n_pad).astype(np.int32)
    want = np.asarray(cc_pallas.masked_min_sweep(
        jnp.asarray(a_pad), jnp.asarray(labels), interpret=True))[:n]
    got = cc.masked_min_sweep(torch.from_numpy(a),
                              torch.from_numpy(labels[:n].copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_sweep_values_and_empty_row_sentinel():
    n = 256
    a = np.zeros((n, n), np.uint8)
    a[0, 10] = a[0, 20] = 1
    a[5, 255] = 1
    labels = torch.arange(n, dtype=torch.int32) * 3
    out = cc.masked_min_sweep(torch.from_numpy(a), labels).numpy()
    assert out[0] == 30
    assert out[5] == 255 * 3
    assert out[1] == cc.BIG_LABEL == 2**30


def test_sweep_rejects_bad_inputs():
    a = torch.zeros(8, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        cc.masked_min_sweep(a, torch.arange(8))                     # int64 labels
    with pytest.raises(ValueError):
        cc.masked_min_sweep(a, torch.arange(7, dtype=torch.int32))  # shape
    with pytest.raises(ValueError):
        cc.masked_min_sweep(a.t()[:, :4].t(), torch.arange(4, dtype=torch.int32))
