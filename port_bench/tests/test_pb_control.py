"""On the card, at the cell's own size: the program within every limit, and
outside one both the control and the perception control (YOLOv5 alone
in TF32 on the reference's exact images), on three seeds (the readings
the limits were set from are in PERF.md). Run there with
`python -m pytest -m cuda port_bench/tests`."""
import pytest

from port_bench import calibrate, compare, core
from conftest import CELL


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2**31 + 21, 3_000_000_021])
def test_control_fails_and_program_passes_at_full_size(cuda_card, seed):
    limits = core.cell_files(CELL)[0]["limits"]
    rec = calibrate.readings(CELL, seed, 0.1)
    ok, checks = compare.judge(rec["program"], limits)
    assert ok, checks
    ok, checks = compare.judge(dict(rec["control"], decision_mismatches=0),
                               limits)
    assert not ok, checks
    cand = {k: limits[k] for k in rec["perception_control"]}
    ok, checks = compare.judge(rec["perception_control"], cand)
    assert not ok, checks
