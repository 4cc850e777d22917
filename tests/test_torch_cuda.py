"""On the card: the CUDA kernel and the device scorer against their plain
versions.  Every test here needs a CUDA card and skips without one.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs on a
machine with PyTorch alone.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.vectorized import bm25_topk, stable_topk
from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                               bm25_blockmax_topk,
                                               bm25_topk_ref, kernel, ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _sparse(seed, t, nb, bs, fill):
    rng = np.random.default_rng(seed)
    imp = rng.random((t, nb, bs), dtype=np.float32)
    imp *= rng.random((t, nb, bs)) < fill
    return torch.from_numpy(imp.astype(np.float32))


@pytest.mark.parametrize("t,nb,bs", [(4, 8, 128), (3, 5, 100), (2, 3, 7),
                                     (3, 2, 1500), (0, 4, 128), (1, 1, 1)])
def test_sweep_bitwise_equals_plain(cuda_device, t, nb, bs):
    imp = _sparse(t + nb, t, nb, bs, 0.2).to(cuda_device)
    bmax = imp.amax(2)
    ub = ref.term_sum(bmax)
    for theta in (ub.median().reshape(1), torch.zeros(1, device=cuda_device)):
        before = kernel.launches
        got = blockmax_scores(imp, bmax, theta)
        assert kernel.launches == before + 1
        assert torch.equal(got, ref.blockmax_scores(imp, bmax, theta))
        assert torch.equal(got.cpu(), ref.blockmax_scores(
            imp.cpu(), bmax.cpu(), theta.cpu()))


def test_topk_matches_exhaustive_and_host(cuda_device):
    imp = _sparse(1, 8, 32, 128, 0.1)
    got = bm25_blockmax_topk(imp.to(cuda_device), imp.amax(2).to(cuda_device),
                             k=25)
    want = bm25_topk_ref(imp, 25)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_wrapper_rejects_non_contiguous(cuda_device):
    imp = torch.zeros(2, 8, 3, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        blockmax_scores(imp, torch.zeros(2, 3, device=cuda_device),
                        torch.zeros(1, device=cuda_device))


def test_dense_scorer_matches_host(cuda_device):
    rng = np.random.default_rng(4)
    q, t, l, n = 4, 8, 256, 4096
    doc_idx = np.full((q, t, l), n, np.int32)
    impacts = np.zeros((q, t, l), np.float32)
    for qi in range(q):
        for ti in range(t):
            m = int(rng.integers(0, l))
            doc_idx[qi, ti, :m] = rng.choice(n, m, replace=False)
            impacts[qi, ti, :m] = rng.choice([0.5, 1.25, 2.0], m)
    qmask = np.ones((q, t), np.float32)
    args = [torch.from_numpy(a) for a in (doc_idx, impacts, qmask)]
    want = bm25_topk(*args, n_docs=n, k=50)
    got = bm25_topk(*[a.to(cuda_device) for a in args], n_docs=n, k=50)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_stable_topk_on_card_matches_host(cuda_device):
    x = torch.from_numpy(np.random.default_rng(2).choice(
        np.array([0.0, 1.0, 2.0], np.float32), size=(3, 10_000)))
    got = stable_topk(x.to(cuda_device), 500)
    want = stable_topk(x, 500)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
