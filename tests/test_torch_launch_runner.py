"""`chip_smoke.run_launch`, which runs a module under `torch.distributed.run`
through the launch-counting runner, on the CPU: two ranks that print many
lines each hand back every line whole, rank 0's first, and both ranks'
kernel launches summed."""
import importlib.util
import os
import re
import textwrap

import pytest

from .torch_parity import one_cpu_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = 20000


@pytest.fixture()
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_ranks_lines_stay_whole(chip_smoke, tmp_path, monkeypatch):
    """Each rank prints LINES lines and counts launches of its own; the
    lines come back unsplit and in rank order, and the `launches` lines of
    both ranks are summed (two ranks sharing one pipe once ran two of
    them into one line)."""
    (tmp_path / "noisy_ranks.py").write_text(textwrap.dedent(f"""
        import os
        from gaussianrpg_tpu_torch.ops import blend, fields, gather, scan
        rank = int(os.environ["RANK"])
        blend.launches += 1 + rank
        scan.launches += 10
        gather.launches += 2
        fields.launches += 3
        for i in range({LINES}):
            print("rank", rank, "line", i, "x" * (i % 37))
        """))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    work = tmp_path / "work"
    work.mkdir()
    rc, lines, launches, _ = chip_smoke.run_launch(
        2, "noisy_ranks", [], str(work), timeout=300)
    assert rc == 0, lines[-1:]
    expected = [f"rank {r} line {i} " + "x" * (i % 37)
                for r in range(2) for i in range(LINES)]
    got = [ln for ln in lines if re.match(r"rank \d", ln)]
    assert [ln.rstrip() for ln in got] == [ln.rstrip() for ln in expected]
    assert launches == {"blend_fwd": 3, "cummax": 20, "blend_bwd": 0,
                        "gather_rows": 4, "primitive_fields": 6}
