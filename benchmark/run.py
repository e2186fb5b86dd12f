"""Run one benchmark cell once, on the card this process is started on.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic file are found by name from
``BENCHMARK.json``; the traffic file names its ``benchmark/drivers/`` module.
Set-up (``setup_s``) runs from the start of this process to the start of
the window: imports, weights, the kernels' build on a checkout's first run,
and the warm-up of the cell's shapes. With ``--trace 0`` the result line
holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics (``benchmark/metrics/<name>.py``) from a ``torch.profiler`` trace of
the window's first unit of work. After the window, and once the program's
state is freed, the plain reference judges what the window produced
(``correct``); every number compared is printed beside its limit, on
standard error and as the result line's last key.

Exits non-zero, and prints no result, when no CUDA card is visible or
fewer than the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or
``mpinets_tpu`` were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mpinets_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_metric(name):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_of(bench, name):
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def per_layer_for(bench, cell):
    """The per-layer metrics this cell reports: those that list it."""
    return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]


def trace_context(driver, trace, prof, cfg, window_s):
    """What every per-layer reader (``benchmark/metrics/<name>.py``) is
    given, whatever the driver: the reduced trace (:mod:`benchmark.trace`),
    the profile itself, the configuration, the traced window's seconds, and
    the driver's ``traced_unit()``: ``batch``; ``steps``, the policy steps
    the traced unit ran; ``work``, ``counts.step_work`` of some of them by
    the reference's ball query; ``unit_s``, the seconds the same unit took
    untraced in this run."""
    return dict(trace=trace, prof=prof, cfg=cfg, window_s=window_s, **driver.traced_unit())


def end_to_end_for(bench, cell):
    return [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def profile_first(holder):
    """Wrap a unit of work in the profiler, marked as the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])

    def run(fn):
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                out = fn()
                if card:
                    torch.cuda.synchronize()
        holder["prof"] = prof
        return out

    return run


def run_cell(bench, cell, cfg, traffic, seed, seconds, trace, device):
    """One run of a cell on ``device`` (a CUDA card, or the CPU in the
    benchmark's own tests, which then runs the system's plain paths).
    -> the result line's dict, its ``checks`` last."""
    import torch

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
        cfg, traffic, seed, device)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    traced = {}
    e2e = driver.window(seconds, profile_first(traced) if trace else None)
    sync()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()

    t_check = time.perf_counter()
    nums, info = driver.numbers()
    info["check_s"] = time.perf_counter() - t_check
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    result = {"correct": all(v <= limits[k] for k, v in nums.items()),
              "attempted": driver.attempted, "failed": driver.failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": memory_peak}
    if trace:
        from benchmark import trace as trace_mod

        t_trace = time.perf_counter()
        tr = trace_mod.collect(traced["prof"], "bench.window")
        window_s = (tr.window[1] - tr.window[0]) / 1e6
        ctx = trace_context(driver, tr, traced["prof"], cfg, window_s)
        metrics = {}
        for m in per_layer_for(bench, cell):
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=trace_mod.busy_us(tr) / 1e6, window_s=window_s)
        result["breakdown"] = trace_mod.breakdown(tr)
        info.update(launches_in_traced_window=tr.launches, device_ops_in_traced_window=len(
            tr.device), trace_s=time.perf_counter() - t_trace)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in end_to_end_for(bench, cell):
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["info"] = dict(info, setup_s=setup_s)
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic = cell_of(bench, args.workload)

    import torch

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell["chips"]:
        log(f"no result: {cell['name']} needs {cell['chips']} CUDA card(s), {visible} visible")
        return 2
    result = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0))
    result["card"] = card_line()
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {', '.join(bad)}")
        return 3
    checks = result.pop("checks")
    log(f"card: {result['card']}; info {json.dumps(result['info'])}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
