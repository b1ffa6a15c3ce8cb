"""What the benchmark's process loads and how it exits: a CPU rehearsal of
each cell at a tiny size loads no JAX module (top-level names compared
whole); without a card, or without the port beside it, a run prints no
result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import tiny_overrides

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

REHEARSAL = """
import json, sys
sys.path[0] = {root!r}
from port_bench import core
out = core.run_cell({cell!r}, 2**31 + 5, 0.01, False, "cpu",
                    overrides=json.loads({ov!r}))
print(json.dumps(dict(correct=out["correct"],
                      tops=sorted({{m.split(".")[0] for m in sys.modules}}),
                      banned=core.banned_modules())))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_loads_no_jax(cell):
    code = REHEARSAL.format(root=str(ROOT), cell=cell,
                            ov=json.dumps(tiny_overrides()))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["banned"] == []
    assert "gaussianrpg_tpu_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "gaussianrpg_tpu"} & set(out["tops"])


def test_banned_names_are_compared_whole(monkeypatch):
    from port_bench import core

    monkeypatch.setitem(sys.modules, "gaussianrpg_tpu_torch_extra", sys)
    assert "gaussianrpg_tpu_torch_extra" not in core.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert core.banned_modules() == ["jaxlib"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = REHEARSAL.format(root=str(tmp_path), cell=CELLS[0],
                            ov=json.dumps(tiny_overrides()))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout == ""
    assert "gaussianrpg_tpu_torch" in res.stderr
