"""The micro-op probes by reps: each op's time at 0, 1, 8 and 32 reps on
the probe session's inputs, and gather's on indices that give every bank
the same number of outputs a block (``idx[row, l] = l``), beside the launch
floor (an empty kernel in the same loop).

    python -m mpinets_torch.probes.reps [--seed S] [--ops OP [OP ...]]

The time at 0 reps is the op's load, setup and launch; the slope after it
is its cost a rep; the balanced indices show what the busiest bank of a
gather block costs. One JSON line each on stdout, the first naming the
card and the launch floor. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mpinets_torch.probes import micro, session
from mpinets_torch.utils.device import resolve_device

REPS = (0, 1, 8, 32)
OPS = ("gather", "roll_narrow", "roll_wide", "vadd", "bd_matmul")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mpinets_torch.probes.reps",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ops", nargs="+", choices=OPS, default=OPS,
                        help="the ops to time (all by default)")
    args = parser.parse_args(argv)
    dev = resolve_device(None)
    print(json.dumps(dict(kind="device", name=torch.cuda.get_device_name(dev),
                          card=session._card(), launch_floor_ms=session.launch_floor_ms(dev))),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rows, rb = session.FULL["rows"], session.FULL["rb"]
    a = torch.rand((rows, 128), generator=gen, device=dev)
    idx = torch.randint(0, 128, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
    lane = torch.arange(128, device=dev, dtype=torch.int32).expand(rows, 128).contiguous()
    cases = [(op, idx, op) for op in args.ops] + [("gather", lane, "gather_balanced")] * (
        "gather" in args.ops)
    for op, ix, name in cases:
        for reps in REPS:
            ms = session.diff_ms(lambda: micro.micro_probe(a, ix, op, reps, rb))
            print(json.dumps(dict(kind="time", name=name, reps=reps, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
