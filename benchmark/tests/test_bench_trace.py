"""The profiler arithmetic on a synthetic event list."""

import pytest

from benchmark import trace
from benchmark.tests.conftest import ROOT


def load(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics"
                                                  / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def synthetic():
    device = [("void sa_kernel_mma<64>(SaArgs)", 10.0, 30.0),
              ("sa_select_kernel(SelArgs)", 25.0, 40.0),      # overlaps the one before
              ("void fps_kernel<float, 4>(...)", 60.0, 70.0),
              ("Memcpy HtoD", 90.0, 95.0),
              ("void sa_kernel<8, false>(SaArgs)", 200.0, 210.0)]   # after the window
    host = [("bench.window.step", 0.0, 100.0), ("aten::cat", 40.0, 59.0),
            ("aten::copy_", 70.0, 92.0)]
    return trace.Trace(device, host, launches=8, window=(0.0, 100.0))


def test_union_counts_overlap_once_and_clips_to_the_window():
    tr = synthetic()
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.busy_us(tr) == pytest.approx(30 + 10 + 5)
    assert trace.idle_share(tr) == pytest.approx(1 - 45 / 100)


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    gaps = dict(trace.idle_gaps(synthetic()))
    assert gaps["aten::cat"] == pytest.approx(20e-6)       # 40 -> 60
    assert gaps["aten::copy_"] == pytest.approx(20e-6)     # 70 -> 90
    assert gaps["bench.window.step"] == pytest.approx(15e-6)   # 0 -> 10, 95 -> 100


def test_per_step_metrics():
    tr = synthetic()
    # the untraced unit took twice the traced window: busy 45 us of 200
    ctx = {"trace": tr, "steps": 4, "window_s": 100e-6, "unit_s": 200e-6, "work": [],
           "cfg": {}}
    assert load("launches_per_step.rollout").read(ctx) == 2.0
    assert load("idle_share.rollout").read(ctx) == pytest.approx(77.5)
    assert load("idle_share.train").read(ctx) == pytest.approx(77.5)
    assert load("idle_share.rollout").read(dict(ctx, unit_s=None)) is None
    # nothing to read: no work counted, so no share of a roofline
    assert load("sa_mlp_roofline").read(ctx) is None
    empty = trace.Trace([], [], 0, (0.0, 1.0))
    assert load("launches_per_step.rollout").read(dict(ctx, trace=empty)) is None


def test_roofline_sums_bounds_over_summed_time():
    import json

    cfg = json.loads((ROOT / "benchmark/configs/mpinets-bf16.json").read_text())
    tr = synthetic()
    # one step's fps launches bounded at 5 us in all, measured 10 us, 2 steps
    work = {"fps": [(3.35e12 * 2e-6, 0.0, 0.0), (3.35e12 * 0.5e-6, 0.0, 0.0)]}
    ctx = {"trace": tr, "steps": 2, "window_s": 1.0, "work": [work, work], "cfg": cfg}
    assert load("fps_roofline").read(ctx) == pytest.approx(100.0 * 2 * 2.5e-6 / 10e-6)
    assert trace.kernel_us(tr, lambda n: "sa_kernel_mma" in n) == 20.0


@pytest.mark.parametrize("name,forwards", [("mfu.rollout", 1.0), ("mfu.train", 3.0)])
def test_mfu_over_the_untraced_unit(name, forwards):
    tr = synthetic()
    cfg = {"compute_dtype": "bfloat16"}
    work = [{"model_flops": 1e12}, {"model_flops": 3e12}]
    ctx = {"trace": tr, "steps": 10, "window_s": 1.0, "unit_s": 2.0, "work": work, "cfg": cfg}
    # 10 steps of 2 TFLOP (the kept steps' mean) in 2 s untraced, against 989 TFLOP/s
    assert load(name).read(ctx) == pytest.approx(100.0 * forwards * 20e12 / 2.0 / 989e12)
    assert load(name).read(dict(ctx, unit_s=None)) is None
