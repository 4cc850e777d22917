"""The port's JSON store against the reference's (paper Figs. 4-6).

Both packages' ``add_json`` + ``annotate_dates`` over the same
``json_collection`` must give the same addresses and features; the nine
Fig. 6 queries must give the reference benchmark's answers on the port's
lazy engine, on the port's vectorized operators (the composition that
``chip_smoke.py`` runs on the card, here on the CPU), and on the reference
index's segments carried across with ``convert.index_from_records``.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the repository root's card script)
from benchmarks import json_queries as jqueries  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.core import json_store as jjson  # noqa: E402
from repro.data.synth import json_collection as jjson_collection  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.convert import index_from_records  # noqa: E402
from repro_torch.core import json_store as tjson  # noqa: E402
from repro_torch.data.synth import json_collection  # noqa: E402

SCALE = 0.5


@pytest.fixture(scope="module")
def stores():
    """(reference warren, port warren, port warren over the reference's
    segment records), all dated."""
    jw = jcore.Warren(jcore.DynamicIndex())
    data = jjson_collection(seed=0, scale=SCALE)
    with jw:
        jw.transaction()
        for name, objs in data.items():
            for obj in objs:
                jcore.add_json(jw, obj, collection=f"Files/{name}.json")
        jw.commit()
    with jw:
        jw.transaction()
        jdated = jcore.annotate_dates(jw, chip_smoke.DATE_PATHS)
        jw.commit()
    tw, n_objects, dated = chip_smoke.build_json_warren(SCALE)
    assert (n_objects, dated) == (sum(len(v) for v in data.values()), jdated)
    carried = tcore.Warren(index_from_records(
        [s.to_record() for s in jw.index._segments]))
    return jw, tw, carried


@pytest.fixture(scope="module")
def answers(stores):
    jw, tw, carried = stores
    out = {}
    with jw:
        out["reference"] = [fn() for _, fn in jqueries.queries(jw)]
    with tw:
        out["lazy"] = [fn() for _, fn in chip_smoke.fig6_lazy(tw)]
        d = chip_smoke.DeviceAlgebra(tw, torch.device("cpu"))
        out["vectorized"] = [fn() for _, fn in chip_smoke.fig6_device(d)]
        out["joins"] = d.joins
    with carried:
        out["carried"] = [fn() for _, fn in chip_smoke.fig6_lazy(carried)]
    return out


def test_collection_is_the_same():
    assert json_collection(3, 0.2) == jjson_collection(3, 0.2)


def test_store_layout_is_the_same(stores):
    jw, tw, _ = stores
    features = [":", ":title:", ":authors:", ":authors:[0]:", ":rating:",
                ":created_at:$date:", "Files/trades.json", "year=2008",
                "month=06", "day=01", "nanotech"]
    with jw, tw:
        for f in features:
            a, b = jw.annotations(f), tw.annotations(f)
            assert len(a) > 0, f
            assert np.array_equal(a.starts, b.starts), f
            assert np.array_equal(a.ends, b.ends), f
            assert np.array_equal(a.values, b.values), f


@pytest.mark.parametrize("i", range(9))
def test_fig6_query_matches_reference(answers, i):
    want = answers["reference"][i]
    assert answers["lazy"][i] == want
    assert answers["vectorized"][i] == want
    assert answers["carried"][i] == want


def test_fig6_composition_counts_its_joins(answers):
    # queries 1-9 run 1+2+4+1+1+1+0+2+1 containment operators
    assert answers["joins"] == 13


def test_values_and_rendering_match_reference(stores):
    jw, tw, _ = stores
    with jw, tw:
        for p, q, _ in list(tw.annotations(":name:"))[:20]:
            p, q = int(p), int(q)
            assert tjson.value_of(tw, p, q) == jjson.value_of(jw, p, q)
            assert tjson.raw_value_of(tw, p, q) == jjson.raw_value_of(jw, p, q)
        lo, hi, _ = next(iter(tw.annotations(":")))
        toks = tw.tokens(int(lo), int(hi))
        assert tjson.render_tokens(toks) == jjson.render_tokens(toks)
        node = tjson.string_match(tw, "new york")
        assert node.solutions() == jjson.string_match(jw, "new york") \
            .solutions()


@pytest.mark.parametrize("text", ["Jan 5 2008", "2008-06-01T10:00",
                                  "1212300000000", "sometime", "feb 30 2010"])
def test_parse_date_matches_reference(text):
    assert tjson.parse_date(text) == jjson.parse_date(text)


def test_add_json_matches_reference_on_one_object():
    obj = {"a": [1, 2.5, None], "b": {"c": "x y", "d": True}, "e": "z"}
    features = [":", ":a:", ":a:[1]:", ":a:[2]:", ":b:", ":b:c:", ":b:d:",
                ":e:", "Files/t.json", "x"]
    out = []
    for core in (jcore, tcore):
        w = core.Warren(core.DynamicIndex())
        with w:
            w.transaction()
            extent = core.add_json(w, obj, collection="Files/t.json")
            w.commit()
        with w:
            out.append((extent, [[tuple(map(float, x))
                                  for x in w.annotations(f)]
                                 for f in features],
                        w.translate(0, 1000)))
    assert out[0] == out[1]
    assert all(out[1][1])
