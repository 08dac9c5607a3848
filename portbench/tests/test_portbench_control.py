"""The control of ``correct``, at a size a CPU test run holds: the
reference at the next precision below the configuration's (bf16 for the fp32
corpus, int4 for the int8 one), put in the program's place, comes out not
correct through the harness's own comparison.

On the card, at each cell's own size, ``portbench/control.py`` runs the
same over several seeds (the upper readings the limits were set from).
"""

from __future__ import annotations

import pytest

from portbench.reference import CONTROL_OF
from portbench.tests.conftest import SEED

CELLS = ["nq.batch-search", "msmarco.seal"]


def _control_run(tiny, cell, device):
    storage = tiny.configuration(tiny.workload(cell)["config"])["storage"]
    res = tiny.run_cell(cell, SEED, 1.0, False, device=device, control=CONTROL_OF[storage])
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert res["correct"] is False and failing, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    _control_run(tiny, cell, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(tiny, cell):
    """The same through the kernels, at the tiny size (the card is looked
    for inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _control_run(tiny, cell, "cuda")
