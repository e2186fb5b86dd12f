"""Run the probe session (:mod:`mpinets_torch.probes.session`).

Usage::

    python -m mpinets_torch.probes [--device cpu] [--batch B] [--seed S]

On the card (the default) it prints, one JSON line each, every probe
kernel against its plain version and its time; ``--device cpu`` runs the
plain versions at small shapes and times nothing.
"""

from __future__ import annotations

import argparse
import sys

from mpinets_torch.probes import session


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m mpinets_torch.probes",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--batch", type=int, default=None,
                        help="batch of the scan and wide probes (256 on the card, 2 on the CPU)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    session.run(args.device, args.batch, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
