"""The port's bench (``python -m mpinets_torch.bench``) on the CPU.

``measure_batch`` runs the rollout through the kernel forward's plain
versions at small sizes (``tests/test_torch_rollout.py``'s); ``main`` at
the reference sizes on ``--device cpu`` prints one JSON line last with
``bench.py``'s keys (less ``vs_baseline``) and its own; its parser takes
every flag of the JAX package's ``bench.py --help`` (run unedited, in a
subprocess) with the same default and choices.
"""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpinets_torch import bench
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.policy import MotionPolicyNetwork

REPO = Path(__file__).resolve().parent.parent
NPOINTS = (16, 8)
SIZES = PointCloudSizes(64, 48, 16)
TINY = ["--device", "cpu", "--batch", "2", "--steps-short", "1", "--steps-long", "2",
        "--repeats", "1"]
CONFIG_KEYS = {"sa_impl", "fast_grouping", "fps_impl", "batch", "fused", "bf16_cloud",
               "compute_dtype", "device"}

# The JAX script's flags, defaults and choices: its parser's actions, read
# as it parses ``--help``.
JAX_FLAGS = """
import argparse, json, runpy, sys
parse_args = argparse.ArgumentParser.parse_args
def dump(self, args=None, namespace=None):
    print(json.dumps({a.dest: [a.default, list(a.choices or ())] for a in self._actions
                      if a.dest != "help"}))
    return parse_args(self, args, namespace)
argparse.ArgumentParser.parse_args = dump
sys.argv = ["bench.py", "--help"]
runpy.run_path("bench.py", run_name="__main__")
"""


@pytest.fixture(scope="module")
def small():
    model = MotionPolicyNetwork(compute_dtype=torch.bfloat16, sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(0)).eval()
    return model, make_fused_apply(torch.bfloat16, fast_grouping=4)


def test_measure_batch_rates_are_finite_and_positive(small):
    model, apply_fn = small
    rates = bench.measure_batch(model, apply_fn, 3, 1, 3, 2, "cpu", sizes=SIZES)
    assert 1 <= len(rates) <= 2
    assert all(math.isfinite(r) and r > 0 for r in rates)


def test_measure_batch_keeps_one_rate_per_repeat_where_long_is_longer(small, monkeypatch):
    """Each rollout still runs; the clock is scripted: two warm-ups, then
    (short, long) per repeat. The repeat whose long run is not the longer
    is dropped."""
    model, apply_fn = small
    seconds = iter([9.0, 9.0, 1.0, 3.0, 2.0, 1.5, 0.5, 1.0])
    run = bench._run_sync

    def scripted(*args):
        run(*args)
        return next(seconds)

    monkeypatch.setattr(bench, "_run_sync", scripted)
    rates = bench.measure_batch(model, apply_fn, 3, 1, 3, 3, "cpu", sizes=SIZES)
    assert rates == [3 * 2 / 2.0, 3 * 2 / 0.5]
    assert next(seconds, None) is None


def test_main_prints_one_json_line_last(capsys):
    result = bench.main(TINY)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    assert set(last) == {"metric", "value", "unit", "median", "rates", "config", "card"}
    assert "vs_baseline" not in last
    assert last["metric"] == "env_steps_per_s_per_chip" and last["unit"] == "steps/s"
    assert last["config"] == {"sa_impl": "v8", "fast_grouping": 4, "fps_impl": "v1",
                              "batch": 2, "fused": True, "bf16_cloud": False,
                              "compute_dtype": "bfloat16", "device": "cpu"}
    assert last["card"] is None
    assert list(last["rates"]) == ["2"] and len(last["rates"]["2"]) <= 1
    assert last["value"] == max(last["rates"]["2"], default=0.0) >= 0
    assert "# batch 2:" in err


def test_profile_leaves_a_trace_and_no_fused_runs_the_plain_forward(tmp_path, capsys):
    result = bench.main(TINY + ["--profile", str(tmp_path), "--no-fused", "--gather16"])
    err = capsys.readouterr().err
    traces = list(tmp_path.iterdir())
    assert [p.name for p in traces] == ["rollout_b2_1steps.json"]
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert result["config"]["fused"] is False and set(result["config"]) == CONFIG_KEYS
    assert "--no-fused: the plain policy forward" in err
    assert "WARNING: --gather16" in err


def test_parser_takes_every_flag_of_the_jax_bench_with_its_default():
    out = subprocess.run([sys.executable, "-c", JAX_FLAGS], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    first, help_text = out.stdout.split("\n", 1)
    jax_actions = json.loads(first)
    flags = set(re.findall(r"--[a-z0-9][-a-z0-9]*", help_text)) - {"--help"}
    assert {f[2:].replace("-", "_") for f in flags} == set(jax_actions)
    ours = {a.dest: a for a in bench._parser()._actions if a.dest != "help"}
    assert set(ours) - set(jax_actions) == {"device"}
    for flag in sorted(flags):
        dest = flag[2:].replace("-", "_")
        assert flag in ours[dest].option_strings, flag
        default, choices = jax_actions[dest]
        assert ours[dest].default == default, flag
        assert list(ours[dest].choices or ()) == choices, flag


def test_bench_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "2"])
