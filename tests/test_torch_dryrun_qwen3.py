"""The one-card dry run on CPU fakes: Qwen3-MoE-235B-A22B's four cells at
full width (``test_torch_dryrun_lm.check_cell``)."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_dryrun_lm import cells_of, check_cell  # noqa: E402

CELLS = cells_of("qwen3-moe-235b-a22b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_qwen3_moe_cell_on_cpu_fakes(arch, shape):
    check_cell(arch, shape)
