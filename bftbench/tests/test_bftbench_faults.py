"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: the control (no verification) and each fault a cell
can have, planted just before the window of a tiny CPU run. The sound
program passes at the same sizes."""

import pytest

from tiny import run_tiny

CASES = [
    ("lightstorm.hub180", None),
    ("lightstorm.hub180", "verify_off"),
    ("lightstorm.hub180", "half_batch"),
    ("lightstorm.hub180", "answer_altered"),
    ("catchup.osmosis150", None),
    ("catchup.osmosis150", "verify_off"),
    ("catchup.osmosis150", "half_batch"),
    ("catchup.osmosis150", "answer_altered"),
    ("catchup.osmosis150", "state_unchanged"),
]


# catch-up's other store and tx mix, which a configuration may name
ON_DISK = dict(db_backend="sqlite", tx_mix="drawn", tx_bytes=64, key_space=32)
CASES += [("catchup.osmosis150", None, ON_DISK), ("catchup.osmosis150", "verify_off", ON_DISK)]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1] or 'sound'}{'-on_disk' if len(c) > 2 else ''}"
                                             for c in CASES])
def test_correct_only_when_the_timed_path_is_sound(case):
    cell, fault, extra = (*case, None)[:3]
    line = run_tiny(cell, seconds=2.0, fault=fault, extra=extra)
    numbers = {n: c["value"] for n, c in line["checks"].items()}
    if fault is None:
        assert line["correct"], numbers
    else:
        assert not line["correct"], numbers
