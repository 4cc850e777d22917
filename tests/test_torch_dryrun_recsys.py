"""The one-card dry run on CPU fakes: the four recsys architectures'
sixteen cells at full width (``test_torch_dryrun_lm.check_cell``), the
train cells through the ``embedding_bag`` backward operator's fake."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_dryrun_lm import cells_of, check_cell  # noqa: E402

CELLS = cells_of("dlrm-rm2", "xdeepfm", "two-tower-retrieval", "sasrec")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_recsys_cell_on_cpu_fakes(arch, shape):
    rec = check_cell(arch, shape)
    assert rec["kind"] == ("train" if shape == "train_batch" else "serve")
