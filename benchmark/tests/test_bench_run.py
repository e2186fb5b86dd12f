"""A run without a card gives no number; on the CPU at a small size (the
system's plain paths) a sound run is correct, the control fails its limits,
and each planted fault makes ``correct`` false."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, faults, run
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 11
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {w["name"]: run.cell_of(BENCH, w["name"])[2]["driver"] for w in BENCH["workloads"]}
PLANTED = [(c, f) for c in CELLS for f in faults.FAULTS[KIND[c]]
           if c == CELLS[0] or KIND[c] != KIND[CELLS[0]]]


def small(name, batch=6, steps=3):
    """The cell at a size a CPU test holds: a smaller batch, fewer steps."""
    cell, cfg, traffic = run.cell_of(BENCH, name)
    if traffic["driver"] == "rollout":
        return cell, cfg, dict(traffic, batch=batch, steps=steps, pool=2)
    return cell, cfg, dict(traffic, batch=batch, trace_steps=1)


def test_no_card_no_number():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT / ".bench_cache")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_on_the_cpu(name):
    cell, cfg, traffic = small(name)
    res = run.run_cell(BENCH, cell, cfg, traffic, SEED, 0.0, 0, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    reported = {m["name"] for m in run.end_to_end_for(BENCH, cell)}
    assert set(res["metrics"]) == reported


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    cell, cfg, traffic = small(name)
    nums, low, _ = control.one(cfg, traffic, SEED, torch.device("cpu"))
    assert all(v <= cfg["limits"][k] for k, v in nums.items()), nums
    assert any(v > cfg["limits"][k] for k, v in low.items()), low


@pytest.mark.parametrize("name,fault", PLANTED)
def test_planted_fault_is_not_correct(name, fault):
    cell, cfg, traffic = small(name)
    nums, _, _ = control.one(cfg, traffic, SEED, torch.device("cpu"), fault)
    assert any(v > cfg["limits"][k] for k, v in nums.items()), (fault, nums)
