"""Readings that the limits of ``correct`` are set from, for one cell:

    python3 -m benchmark.control --workload <name> --seeds 12 --fault-seeds 3 --out FILE

For each of ``--seeds`` seeds, the cell's set-up and one unit of its work
(a rollout of the cell's batch and length, or the first train steps and
one more) through the timed path, and its numbers against the reference
(the program's sound readings), and the control's:
the reference computed in the precision below the configuration's
(``control_precision``: fp8 under bf16, TF32 under f32) put in the
program's place on the same captured inputs. Then, on ``--fault-seeds``
seeds, the same with each of :mod:`benchmark.faults` planted. Writes every
reading and, per number, the largest sound reading and the smallest
control and fault readings as JSON. It makes no result line and is not
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from benchmark import faults, generate, run


def one(cfg, traffic, seed, device, fault=None):
    """(numbers, control numbers or None, what the run reports beside its
    numbers) of one window of one unit."""
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
        cfg, traffic, seed, device)
    if fault is None:
        driver.setup()
        driver.window(0.0)
    else:
        with faults.plant(fault, driver, traffic["driver"]):
            driver.setup()
            driver.window(0.0)
    driver.release()
    nums, info = driver.numbers()
    if fault is not None:
        return nums, None, info
    return nums, driver.control_numbers(cfg["control_precision"]), info


def summarize(readings):
    """Per number: the largest of a set of readings (by seed) and the least."""
    keys = sorted({k for nums in readings.values() for k in nums})
    return {k: {"max": max(n[k] for n in readings.values()),
                "min": min(n[k] for n in readings.values())} for k in keys}


def collect(cell, cfg, traffic, seeds, fault_seeds, device, log=print):
    out = {"workload": cell["name"], "program": {}, "control": {}, "faults": {}, "info": {}}
    for s in seeds:
        t0 = time.perf_counter()
        out["program"][s], out["control"][s], out["info"][s] = one(cfg, traffic, s, device)
        log(f"seed {s}: {json.dumps(out['program'][s])} control "
            f"{json.dumps(out['control'][s])} ({time.perf_counter() - t0:.1f} s)")
    for f in faults.FAULTS[traffic["driver"]]:
        out["faults"][f] = {}
        for s in fault_seeds:
            out["faults"][f][s], _, out["info"][f"{f} {s}"] = one(cfg, traffic, s, device, f)
            log(f"fault {f} seed {s}: {json.dumps(out['faults'][f][s])}")
    out["summary"] = {"program": summarize(out["program"]),
                      "control": summarize(out["control"]),
                      "faults": {f: summarize(r) for f, r in out["faults"].items()}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic = run.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        run.log("no CUDA card visible")
        return 2
    seeds = [generate.subseed(args.first_seed, f"control{i}") % 2**32 for i in range(args.seeds)]
    out = collect(cell, cfg, traffic, seeds, seeds[:args.fault_seeds],
                  torch.device("cuda", 0), run.log)
    out["card"] = run.card_line()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"workload": cell["name"], "card": out["card"],
                      "summary": out["summary"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
