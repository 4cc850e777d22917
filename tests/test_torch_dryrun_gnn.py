"""The one-card dry run on CPU fakes: NequIP's four cells at full width,
each a train step (``test_torch_dryrun_lm.check_cell``); ogb_products
(2.4 M nodes, 61.9 M edges) does not fit one card."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_dryrun_lm import cells_of, check_cell  # noqa: E402

CELLS = cells_of("nequip")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_gnn_cell_on_cpu_fakes(arch, shape):
    rec = check_cell(arch, shape)
    assert rec["kind"] == "train"
    assert rec["memory"]["peak_bytes"] > 80e9 if shape == "ogb_products" \
        else rec["memory"]["peak_bytes"] < 80e9
