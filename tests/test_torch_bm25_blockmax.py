"""The port's block-max BM25 against the reference Pallas kernel and ops.

On the CPU the wrapper takes the plain version: it must prune the same
blocks as ``blockmax_scores_pallas`` (interpret mode) at a fixed θ and sum
the same values, and ``bm25_blockmax_topk`` must match the reference at the
reference kernel tests' tolerance.  The CUDA kernel itself runs only on the
card: ``test_torch_cuda.py`` compares it with the plain version there.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)

from repro.kernels import bm25_blockmax_topk as jax_blockmax_topk  # noqa
from repro.kernels import bm25_topk_ref as jax_topk_ref  # noqa: E402
from repro.kernels.bm25_blockmax.kernel import \
    blockmax_scores_pallas  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bm25_blockmax import (blockmax_scores,  # noqa: E402
                                               blockmax_threshold,
                                               bm25_blockmax_topk, kernel,
                                               pruned_fraction)


def _sparse(seed, t, nb, bs, fill):
    rng = np.random.default_rng(seed)
    imp = rng.random((t, nb, bs), dtype=np.float32)
    imp *= rng.random((t, nb, bs)) < fill
    return imp.astype(np.float32)


@pytest.mark.parametrize("t,nb,bs", [(4, 8, 128), (3, 5, 100), (2, 3, 7)])
def test_plain_sweep_matches_pallas(t, nb, bs):
    imp = _sparse(t * 13 + nb, t, nb, bs, 0.2)
    bmax = imp.max(axis=2)
    ub = bmax.sum(axis=0)
    theta = np.float32(np.median(ub))            # prunes about half
    want = np.asarray(blockmax_scores_pallas(jnp.asarray(imp),
                                             jnp.asarray(bmax), theta))
    got = blockmax_scores(torch.from_numpy(imp), torch.from_numpy(bmax),
                          torch.tensor([theta])).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).any() and np.isfinite(got).any()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,t,nb,bs", chip_smoke.SWEEP_EDGES,
                         ids=[c[0] for c in chip_smoke.SWEEP_EDGES])
def test_plain_sweep_matches_pallas_at_kernel_edges(name, t, nb, bs):
    """``chip_smoke.py``'s edge shapes of the CUDA kernel (T past its
    templates, BS in passes and off the lanes, NB past one round of the
    grid, impacts off 16 bytes): the plain sweep equals the Pallas kernel
    (interpret mode) at a θ that prunes about half the blocks, and at 0."""
    imp = torch.from_numpy(chip_smoke.sweep_edge(t, nb, bs))
    if name.endswith("off_16_bytes"):
        imp = chip_smoke.off_16(imp, "cpu")
    bmax = imp.amax(2)
    ub = bmax.sum(0)
    for theta in (np.float32(ub.median()), np.float32(0.0)):
        want = np.asarray(blockmax_scores_pallas(
            jnp.asarray(imp.numpy()), jnp.asarray(bmax.numpy()), theta))
        got = blockmax_scores(imp, bmax, torch.tensor([theta])).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        assert np.isfinite(got).any()
        np.testing.assert_allclose(got[np.isfinite(got)],
                                   want[np.isfinite(want)], rtol=1e-6,
                                   atol=0)


def _plan_writes(t, nb, bs, aligned):
    """How often the launch plan's warps write each (doc block, doc), by
    the kernel's index arithmetic: warp w of the grid's takes doc block w;
    lane i writes documents [e, e + vec) of each pass's 32 · vec."""
    p = kernel.plan(t, nb, bs, aligned)
    writes = np.zeros((nb, bs), np.int64)
    span = 32 * p.vec
    for w in range(min(p.grid * kernel.WARPS, nb)):
        for e0 in range(0, p.passes * span, span):
            for lane in range(32):
                e = e0 + lane * p.vec
                if e < bs:
                    writes[w, e:e + p.vec] += 1
    return p, writes


@pytest.mark.parametrize("t,nb,bs", [(8, 69077, 128), (17, 6, 128),
                                     (3, 5, 132), (4, 7, 96), (2, 4229, 128),
                                     (1, 1, 1), (0, 4, 128), (3, 2, 1500),
                                     (16, 1000, 128), (2, 3, 7)])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_writes_every_doc_once(t, nb, bs, aligned):
    p, writes = _plan_writes(t, nb, bs, aligned)
    assert (writes == 1).all()
    assert p.vec == (4 if aligned and bs % 4 == 0 else 1)
    assert p.terms == (t if 1 <= t <= kernel.MAX_TERMS else 0)
    assert (p.grid - 1) * kernel.WARPS < nb <= p.grid * kernel.WARPS


def test_plan_at_deployment_width():
    """At MS MARCO's [8, 69077, 128]: 16-byte loads, every plane in flight
    (T = 8 compiled), one pass, 8,635 blocks of 8 warps."""
    assert kernel.plan(8, 69077, 128, True) \
        == kernel.Plan(vec=4, terms=8, grid=8635, passes=1)


def _parity(imp, k):
    """Port vs reference ops vs reference oracle: exact positive scores,
    tie-tolerant ids (the reference kernel tests' contract)."""
    bmax = imp.max(axis=2)
    got_s, got_i = bm25_blockmax_topk(torch.from_numpy(imp),
                                      torch.from_numpy(bmax), k=k)
    got_s, got_i = got_s.numpy(), got_i.numpy()
    for want_s, want_i in (
            jax_blockmax_topk(jnp.asarray(imp), jnp.asarray(bmax), k=k),
            jax_topk_ref(jnp.asarray(imp), k)):
        want_s, want_i = np.asarray(want_s), np.asarray(want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
        assert set(got_i[got_s > 0]) == set(want_i[want_s > 0])
    assert np.isfinite(got_s).all()


@pytest.mark.parametrize("t,nb,bs,k", [(4, 8, 128, 10), (8, 32, 128, 25),
                                       (2, 4, 256, 5), (16, 16, 128, 100)])
def test_blockmax_topk_sweep(t, nb, bs, k):
    _parity(_sparse(t * 100 + nb, t, nb, bs, 0.1), k)


def test_blockmax_topk_empty_posting_list():
    _parity(np.zeros((2, 4, 128), np.float32), k=5)


def test_blockmax_topk_single_element_block():
    imp = np.zeros((1, 1, 1), np.float32)
    imp[0, 0, 0] = 2.5
    _parity(imp, k=1)


def test_blockmax_topk_theta_tie_boundary():
    """Blocks tied at exactly UB == θ are swept, not pruned."""
    imp = np.zeros((1, 4, 8), np.float32)
    imp[0, :, 3] = 1.0
    _parity(imp, k=4)
    # at k=2 the probe's 2nd best is 1.0: θ equals every block's UB
    bmax = torch.from_numpy(imp.max(axis=2))
    theta = blockmax_threshold(torch.from_numpy(imp), bmax, 2)
    assert float(theta) == 1.0
    assert float(pruned_fraction(bmax, theta)) == 0.0
    _parity(imp, k=2)


@pytest.mark.parametrize("t,nb,bs,k", [(1, 1, 100, 3), (3, 5, 100, 7),
                                       (2, 3, 7, 4)])
def test_blockmax_topk_block_length_not_warp_multiple(t, nb, bs, k):
    _parity(_sparse(t * 31 + nb, t, nb, bs, 0.2), min(k, nb * bs))


def test_blockmax_topk_k_exceeds_positive_docs():
    imp = np.zeros((2, 2, 8), np.float32)
    imp[0, 0, 1] = 3.0
    imp[1, 1, 4] = 1.5
    _parity(imp, k=10)


def test_blockmax_topk_no_terms_and_small_doc_space():
    s, i = bm25_blockmax_topk(torch.zeros(0, 4, 8), torch.zeros(0, 4), k=3)
    assert s.tolist() == [0.0] * 3 and i.tolist() == [0, 1, 2]
    imp = torch.zeros(1, 1, 4)
    imp[0, 0, 2] = 1.0
    s, i = bm25_blockmax_topk(imp, imp.amax(2), k=10)    # k > NB * BS
    assert s.tolist() == [1.0, 0.0, 0.0, 0.0] and i.tolist() == [2, 0, 1, 3]


def test_blockmax_prunes():
    imp = _sparse(0, 4, 64, 128, 0.05)
    imp[:, :2, :] *= 10
    bmax = torch.from_numpy(imp.max(axis=2))
    s, _ = bm25_blockmax_topk(torch.from_numpy(imp), bmax, k=5)
    assert float(pruned_fraction(bmax, s[-1])) > 0.3


def test_cpu_path_never_launches(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU tensors loaded kernel library {name}")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(kernel, "launches", 0)
    imp = torch.from_numpy(_sparse(3, 3, 6, 32, 0.3))
    bm25_blockmax_topk(imp, imp.amax(2), k=5)
    blockmax_scores(imp, imp.amax(2), torch.tensor([0.5]))
    assert kernel.launches == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "theta", "device"])
def test_wrapper_rejects_bad_inputs(case):
    imp = torch.zeros(2, 3, 8)
    bmax, theta = torch.zeros(2, 3), torch.zeros(1)
    if case == "dtype":
        imp = imp.double()
    elif case == "shape":
        bmax = torch.zeros(3, 2)
    elif case == "theta":
        theta = torch.zeros(2)
    else:
        imp = imp.to("meta")
    with pytest.raises((TypeError, ValueError)):
        blockmax_scores(imp, bmax, theta)
