"""The span readers (``benchmark/spans.py`` and the metrics that use it) on a
synthetic trace and event tree, and on a CPU run of each cell traced."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, spans, trace
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_run import SEED, small
from benchmark.tests.test_bench_trace import load

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["host_waits_per_step.rollout", "policy_ms.rollout", "env_ms.rollout", "tail_ms.rollout",
       "env_idle_ms.rollout", "host_waits_per_step.train", "batch_idle_ms.train",
       "step_idle_ms.train"]


def two_steps():
    """Two rollout steps in a window of 0-200 us: policy 0-40 and 100-140,
    env 40-100 and 140-200, a wait inside each env span; device ops leave
    gaps that begin at 30 (policy), 55 (inside the first wait), 90 (env),
    150 (env) and 190 (env, to the window's end)."""
    host = [("rollout.policy", 0.0, 40.0), ("policy.tail", 20.0, 38.0),
            ("rollout.env", 40.0, 100.0), ("wait.h2d.joint_limits", 50.0, 70.0),
            ("aten::add", 85.0, 92.0),
            ("rollout.policy", 100.0, 140.0), ("policy.tail", 120.0, 138.0),
            ("rollout.env", 140.0, 200.0), ("wait.h2d.point_bank", 145.0, 160.0),
            ("wait.h2d.outside", 300.0, 310.0)]                 # after the window
    device = [("sa_kernel_mma", 0.0, 30.0), ("gemm", 35.0, 55.0),
              ("Memcpy HtoD (Pageable -> Device)", 70.0, 90.0), ("add", 95.0, 150.0),
              ("fps", 170.0, 190.0)]
    return trace.Trace(device, host, launches=5, window=(0.0, 200.0))


def test_gaps_lie_between_the_device_union():
    assert spans.gaps(two_steps()) == [(30.0, 5.0), (55.0, 15.0), (90.0, 5.0), (150.0, 20.0),
                                       (190.0, 10.0)]
    empty = trace.Trace([], [], 0, (0.0, 10.0))
    assert spans.gaps(empty) == [(0.0, 10.0)]


def test_gap_is_put_down_to_the_span_it_begins_in():
    tr = two_steps()
    # env: 55 (in the nested wait) 15 + 90 5 + 150 20 + 190 10; policy: 30 5,
    # which begins inside the first step's tail too
    assert spans.idle_us_in(tr, "rollout.env") == 50.0
    assert spans.idle_us_in(tr, "rollout.policy") == 5.0
    assert spans.idle_us_in(tr, "policy.tail") == 5.0
    assert spans.idle_us_in(tr, "wait.h2d.joint_limits") == 15.0
    assert spans.idle_us_in(tr, "wait.h2d.point_bank") == 20.0
    assert spans.idle_us_in(tr, "train.step") is None


def test_per_step_readers_divide_by_steps():
    ctx = {"trace": two_steps(), "steps": 2}
    assert load("env_idle_ms.rollout").read(ctx) == pytest.approx(50e-3 / 2)
    # two waits in the window, whatever span holds them
    assert load("host_waits_per_step.rollout").read(ctx) == 1.0
    assert load("host_waits_per_step.rollout").read(dict(ctx, steps=4)) == 0.5


def test_waits_read_zero_where_the_program_has_spans_and_no_waits():
    tr = two_steps()
    host = [h for h in tr.host if not h[0].startswith("wait.")]
    ctx = {"trace": tr._replace(host=host), "steps": 2}
    assert load("host_waits_per_step.rollout").read(ctx) == 0.0


def event(name, start, end, corr=0, thread=1, device=False, annotation=False):
    dt = torch.autograd.DeviceType
    return SimpleNamespace(name=name, id=corr, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_type=dt.CUDA if device else dt.CPU,
                           is_user_annotation=annotation)


def profile_of_two_steps():
    """Two steps' host ranges and launches, and the device operations they
    launched (matched by correlation id): the policy span launches a hand
    kernel through a bare runtime call and holds the tail, whose product
    launches a GEMM; the env span a wait's copy and an add. The backward
    thread launches a kernel inside the policy's time, which is not the
    policy's; the policy's device-side annotation is no operation."""
    ev = []
    for k, t0 in enumerate((0.0, 100.0)):
        c = 10 * k
        ev += [event("rollout.policy", t0, t0 + 40),
               event("cudaLaunchKernel", t0 + 2, t0 + 3, corr=c + 1),
               event("sa_kernel_mma", t0 + 3, t0 + 33, corr=c + 1, device=True),
               event("policy.tail", t0 + 20, t0 + 38),
               event("aten::mm", t0 + 21, t0 + 25),
               event("cudaLaunchKernel", t0 + 22, t0 + 23, corr=c + 2),
               event("gemm", t0 + 33, t0 + 37, corr=c + 2, device=True),
               event("cudaLaunchKernel", t0 + 5, t0 + 6, corr=c + 3, thread=2),
               event("backward", t0 + 37, t0 + 38, corr=c + 3, device=True),
               event("rollout.policy", t0 + 3, t0 + 40, corr=c + 9, device=True,
                     annotation=True),
               event("rollout.env", t0 + 40, t0 + 100),
               event("wait.h2d.joint_limits", t0 + 45, t0 + 60),
               event("cudaMemcpyAsync", t0 + 46, t0 + 47, corr=c + 4),
               event("Memcpy HtoD (Pageable -> Device)", t0 + 50, t0 + 52, corr=c + 4,
                     device=True),
               event("cudaLaunchKernel", t0 + 70, t0 + 71, corr=c + 5),
               event("add", t0 + 72, t0 + 75, corr=c + 5, device=True)]
    return SimpleNamespace(events=lambda: ev)


def test_device_time_under_a_span_follows_each_launch_by_correlation():
    prof = profile_of_two_steps()
    assert spans.device_us_under(prof, "rollout.policy") == 2 * (30.0 + 4.0)
    assert spans.device_us_under(prof, "policy.tail") == 2 * 4.0
    assert spans.device_us_under(prof, "rollout.env") == 2 * (2.0 + 3.0)
    assert spans.device_us_under(prof, "wait.h2d.joint_limits") == 2 * 2.0
    assert spans.device_us_under(prof, "train.step") is None
    ctx = {"prof": prof, "steps": 2}
    assert load("policy_ms.rollout").read(ctx) == pytest.approx(34e-3)
    assert load("tail_ms.rollout").read(ctx) == pytest.approx(4e-3)
    assert load("env_ms.rollout").read(ctx) == pytest.approx(5e-3)


def test_a_profile_without_spans_reads_none():
    """The parent commit opens no span: every new reader gives None."""
    tr = two_steps()
    bare = tr._replace(host=[("aten::add", 85.0, 92.0)])
    prof = SimpleNamespace(events=lambda: [event("aten::add", 85.0, 92.0),
                                           event("cudaLaunchKernel", 86.0, 87.0, corr=1),
                                           event("add", 90.0, 93.0, corr=1, device=True)])
    ctx = {"trace": bare, "prof": prof, "steps": 2}
    for name in NEW:
        assert load(name).read(ctx) is None, name


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_traced_cpu_run_reports_each_listed_span_metric(name):
    """On the CPU the program's spans are recorded and read (no device
    operation, no wait: zeros)."""
    cell, cfg, traffic = small(name, batch=2, steps=2)
    res = run.run_cell(BENCH, cell, cfg, traffic, SEED, 0.0, 1, torch.device("cpu"))
    listed = {m["name"] for m in run.per_layer_for(BENCH, cell)} & set(NEW)
    assert listed
    for m in listed:
        assert res["metrics"][m]["value"] == 0.0, (m, res["metrics"])
