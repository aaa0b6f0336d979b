"""The command line and the contract of its last line."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from harness import cli, spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARGS = ["--workload", "tree-4k.ladder", "--seed", "2147483701", "--seconds",
        "1", "--trace", "0"]


def _run(cwd, args=ARGS):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_arguments():
    a = cli.parse(ARGS)
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "tree-4k.ladder", 2147483701, 1.0, 0)
    with pytest.raises(SystemExit):
        cli.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                   "--trace", "2"])


def test_every_cell_loads():
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == w["chips"] == cell.config["chips"]
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        spec.load_module("scenes", cell.config["recipe"])
        assert {"mismatch_pct"} <= set(cell.config["limits"])


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_result_line(tmp_path, capsys, monkeypatch):
    """A run's result, as cli.main prints it (the card's check stubbed)."""
    from harness import cell as cell_mod
    import _tiny

    cell = _tiny.tiny_cell()
    real = cell_mod.run
    monkeypatch.setattr(spec, "load_cell", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cell_mod, "run", lambda c, seed, secs, traced, t_process:
                        real(c, seed, secs, traced, device="cpu",
                             t_process=t_process))
    assert cli.main(["--workload", "tree-4k.ladder", "--seed", "3",
                     "--seconds", "2", "--trace", "0"], 0.0) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"msamples_per_s", "peak_mem_gib", "setup_s"}
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("compared mismatch_pct ")
