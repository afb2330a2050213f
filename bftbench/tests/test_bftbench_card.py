"""On the card: each cell's sound run, its control and its faults at the
cell's own size. Skips without an NVIDIA GPU."""

import pytest

from tiny import SEED, bench

CELLS = {"lightstorm.hub180": ("verify_off", "half_batch", "answer_altered"),
         "catchup.osmosis150": ("verify_off", "half_batch", "answer_altered", "state_unchanged")}
CASES = [(c, f) for c, fs in CELLS.items() for f in (None, *fs)]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_at_the_cells_size_on_the_card(cell, fault):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bftbench import faults, run

    undo = []
    line = run.run_cell(cell, SEED, 5.0, False,
                        fault=(lambda: undo.append(faults.plant(fault))) if fault else None, bench=bench())
    for u in undo:
        u()
    assert line["correct"] is (fault is None), line["checks"]
