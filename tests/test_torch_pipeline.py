"""The port's index-backed data pipeline (``repro_torch.data.pipeline``)
against ``repro.data.pipeline``: the same documents ingested into each
package's ``Warren`` give the same ``:``, ``dup:`` and ``seg:``
annotations, and ``IndexedCorpusLoader`` the same batches bit for bit,
across epochs and after ``state``/``restore``; and ``synth.token_batches``
the same LM batches."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import DynamicIndex as JIndex  # noqa: E402
from repro.core import Warren as JWarren  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.core import DynamicIndex as TIndex  # noqa: E402
from repro_torch.core import Warren as TWarren  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402


def _docs(n=40, mean_len=60):
    docs = list(tsynth.doc_generator(3, n, mean_len=mean_len))
    # exact duplicates under new ids, for mark_duplicates
    docs += [(f"dup{i}", docs[i][1]) for i in (0, 5, 7)]
    assert docs[:n] == list(jsynth.doc_generator(3, n, mean_len=mean_len))
    return docs


def _build(window=16, stride=8):
    out = []
    for mod, warren in ((JP, JWarren(JIndex())), (TP, TWarren(TIndex()))):
        n = mod.ingest(warren, _docs(), batch_docs=16)
        dups = mod.mark_duplicates(warren)
        segs = mod.segment(warren, window=window, stride=stride)
        out.append((warren, (n, dups, segs)))
    return out


def _ann(warren, feature):
    with warren:
        lst = warren.annotations(feature)
        return (list(map(int, lst.starts)), list(map(int, lst.ends)),
                [float(v) for v in lst.values])


def test_stages_give_the_same_annotations():
    (jw, jcounts), (tw, tcounts) = _build()
    assert jcounts == tcounts and jcounts[1] == 3
    for feature in (":", TP.DUP_FEATURE, TP.SEG_FEATURE):
        assert _ann(jw, feature) == _ann(tw, feature), feature


@pytest.mark.parametrize("vocab,batch,seq", [(512, 4, 16), (97, 3, 40)])
def test_loader_batches_bit_for_bit_across_epochs(vocab, batch, seq):
    (jw, _), (tw, _) = _build()
    jl = JP.IndexedCorpusLoader(jw, vocab=vocab, batch=batch, seq_len=seq,
                                seed=1)
    tl = TP.IndexedCorpusLoader(tw, vocab=vocab, batch=batch, seq_len=seq,
                                seed=1)
    n = 2 * len(jl.extents) // batch + 3          # past two epochs
    for _ in range(n):
        a, b = next(jl), next(tl)
        assert set(a) == set(b)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert a["_state"] == b["_state"]
    assert tl.epoch >= 2


def test_loader_state_and_restore_resume_the_stream():
    (jw, _), (tw, _) = _build()
    jl = JP.IndexedCorpusLoader(jw, vocab=256, batch=4, seq_len=16)
    tl = TP.IndexedCorpusLoader(tw, vocab=256, batch=4, seq_len=16)
    for _ in range(len(tl.extents) // 4 + 2):
        next(jl)
        next(tl)
    state = tl.state()
    assert state == jl.state()
    want = [next(tl)["tokens"] for _ in range(3)]
    fresh = TP.IndexedCorpusLoader(tw, vocab=256, batch=4, seq_len=16)
    fresh.restore(state)
    jfresh = JP.IndexedCorpusLoader(jw, vocab=256, batch=4, seq_len=16)
    jfresh.restore(state)
    for w in want:
        a, b = next(fresh), next(jfresh)
        assert np.array_equal(a["tokens"], w)
        assert np.array_equal(a["tokens"], b["tokens"])


def test_loader_pads_with_label_zero():
    """Short segments leave zeros in tokens and labels (the reference's
    padding, which its loss does not mask: ROADMAP §3)."""
    (jw, _), (tw, _) = _build()
    tl = TP.IndexedCorpusLoader(tw, vocab=256, batch=8, seq_len=200)
    b = next(tl)
    assert (b["labels"] == 0).any() and (b["tokens"][:, 0] == 1).all()


def test_token_id_and_empty_pipeline():
    for w in ("time", "resonance", "ünïcode", ""):
        assert TP.token_id(w, 1000) == JP.token_id(w, 1000)
    with pytest.raises(ValueError, match="no segments"):
        TP.IndexedCorpusLoader(TWarren(TIndex()), vocab=8, batch=1,
                               seq_len=4)


@pytest.mark.parametrize("start", [0, 5])
def test_token_batches_equal(start):
    jg = jsynth.token_batches(2, 300, 3, 17, start_step=start)
    tg = tsynth.token_batches(2, 300, 3, 17, start_step=start)
    for _ in range(3):
        a, b = next(jg), next(tg)
        assert a["step"] == b["step"]
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])
