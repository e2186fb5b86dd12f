"""Metric comparison harness: our evaluation vs a reference evaluation.

Port of ``mpinets_tpu/eval/compare.py`` (numpy and pickle). The reference
saves its per-group metric dicts with pickle
(``mpinets/metrics.py:708-735``); :class:`mpinets_torch.eval.metrics.Evaluator`
saves the same structure with the same metric keys. This module diffs the
two at three strictness tiers:

* ``exact``  -- identical values (integer counters: total, skips),
* ``rate``   -- percentage metrics within ``rate_tol`` points
               (success, %<1cm, collision rates, ...),
* ``value``  -- continuous metrics within ``value_tol`` relative
               (errors, path lengths, SPARC means, times).

Usage::

    python -m mpinets_torch.eval.compare ours_metrics.pkl theirs_metrics.pkl
        [--rate-tol 0.5] [--value-tol 0.05]

Exit code 0 when every shared group/metric agrees within tolerance, else 1.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Dict, List, Tuple

import numpy as np

from mpinets_torch.eval.metrics import Evaluator

#: integer counters that must match exactly
EXACT_KEYS = {"total", "skips"}
#: percentage/rate metrics compared in absolute points
RATE_HINTS = ("%", "rate", "success", "collision", "violation", "smooth")


def _classify(key: str) -> str:
    if key in EXACT_KEYS:
        return "exact"
    kl = key.lower()
    if any(h in kl for h in RATE_HINTS):
        return "rate"
    return "value"


def _scalarize(v) -> float | None:
    try:
        arr = np.asarray(v, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if arr.size == 0:
        return None
    return float(arr.mean()) if arr.size > 1 else float(arr)


def compare_metric_dicts(
    ours: Dict, theirs: Dict, rate_tol: float = 0.5, value_tol: float = 0.05
) -> List[Tuple[str, str, float, float]]:
    """Returns the list of (key, tier, ours, theirs) DISAGREEMENTS. A
    metric that is NaN on both sides agrees (the JAX package flags it, so
    it reports a run against itself as disagreeing wherever no problem
    succeeded)."""
    bad = []
    for key in sorted(set(ours) & set(theirs)):
        a = _scalarize(ours[key])
        b = _scalarize(theirs[key])
        if a is None or b is None or (np.isnan(a) and np.isnan(b)):
            # NaN on both sides (a mean over no successes) is no disagreement
            continue
        tier = _classify(key)
        if tier == "exact":
            ok = a == b
        elif tier == "rate":
            ok = abs(a - b) <= rate_tol
        else:
            denom = max(abs(b), 1e-9)
            ok = abs(a - b) / denom <= value_tol
        if not ok:
            bad.append((key, tier, a, b))
    return bad


def compare_files(
    ours_path, theirs_path, rate_tol: float = 0.5, value_tol: float = 0.05,
    metrics_fn=None,
) -> Dict[str, List]:
    """Compare two saved evaluation pickles group by group.

    Both files may hold either {group: metric_dict} or {group: raw-lists}
    structures; raw groups are reduced with ``metrics_fn`` (defaults to
    :meth:`mpinets_torch.eval.metrics.Evaluator.metrics`).
    """
    if metrics_fn is None:
        metrics_fn = Evaluator().metrics

    def load(path):
        with open(path, "rb") as f:
            groups = pickle.load(f)
        out = {}
        for k, g in groups.items():
            if isinstance(g, dict) and any(
                isinstance(v, (int, float)) for v in g.values()
            ):
                out[k] = g
            else:
                out[k] = metrics_fn(g)
        return out

    ours = load(ours_path)
    theirs = load(theirs_path)
    report = {}
    for group in sorted(set(ours) & set(theirs)):
        report[group] = compare_metric_dicts(
            ours[group], theirs[group], rate_tol, value_tol
        )
    missing = sorted(set(theirs) - set(ours))
    if missing:
        report["__missing_groups__"] = missing
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ours")
    ap.add_argument("theirs")
    ap.add_argument("--rate-tol", type=float, default=0.5)
    ap.add_argument("--value-tol", type=float, default=0.05)
    args = ap.parse_args(argv)
    report = compare_files(
        args.ours, args.theirs, args.rate_tol, args.value_tol
    )
    ok = True
    for group, bad in report.items():
        if group == "__missing_groups__":
            print(f"MISSING GROUPS: {bad}")
            ok = False
            continue
        if not bad:
            print(f"{group}: OK")
        else:
            ok = False
            print(f"{group}: {len(bad)} disagreements")
            for key, tier, a, b in bad:
                print(f"  {key} [{tier}]: ours={a:.6g} theirs={b:.6g}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
