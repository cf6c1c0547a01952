"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU; skips without one.  Imports no JAX, so on a machine
without it run it past the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from gcanet_tpu_torch.ops import cc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _graph(n, p, gen):
    a = torch.rand(n, n, generator=gen, device="cuda") < p
    a = torch.triu(a, 1)
    return a | a.t()


@pytest.mark.parametrize("n", [7000, 1001, 17, 1])
def test_sweep_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    for p in (0.0, 1e-3, 0.05):
        a = _graph(n, p, gen)
        labels = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
        before = cc.masked_min_sweep.launches
        got = cc.masked_min_sweep(a, labels)
        assert cc.masked_min_sweep.launches == before + 1
        torch.testing.assert_close(got, cc.masked_min_sweep_plain(a, labels), rtol=0, atol=0)


def test_sweep_strided_rows_and_uint8(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    base = torch.zeros(1000, 1005, dtype=torch.bool, device=cuda)
    base[:, :1000] = _graph(1000, 0.01, gen)
    nbr = base[:, :1000]
    labels = torch.arange(1000, dtype=torch.int32, device=cuda).flip(0)
    want = cc.masked_min_sweep_plain(nbr, labels)
    torch.testing.assert_close(cc.masked_min_sweep(nbr, labels), want, rtol=0, atol=0)
    torch.testing.assert_close(cc.masked_min_sweep(nbr.to(torch.uint8), labels), want,
                               rtol=0, atol=0)


def test_connected_components_card_equals_cpu(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = _graph(3000, 4e-4, gen)
    i = torch.arange(299, device=cuda)
    a[i, i + 1] = True                       # a 300-chain
    a[i + 1, i] = True
    torch.testing.assert_close(cc.connected_components(a).cpu(),
                               cc.connected_components(a.cpu()), rtol=0, atol=0)


def test_sweep_rejects_cpu_labels_with_cuda_mask(cuda):
    with pytest.raises(ValueError):
        cc.masked_min_sweep(torch.zeros(4, 4, dtype=torch.bool, device=cuda),
                            torch.arange(4, dtype=torch.int32))
