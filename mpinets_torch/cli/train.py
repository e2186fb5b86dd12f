"""Training CLI.

Port of ``mpinets_tpu/cli/train.py`` (the interface of the reference's
``run_training.py:134-204``), with ``--device``::

    python -m mpinets_torch.cli.train [jobconfig.yaml] [--synthetic-data] [--test]
        [--no-logging] [--no-checkpointing] [--resume EXP_DIR] [--device cuda|cpu]

The YAML may be the reference's ``jobconfig.yaml`` layout or this package's
nested layout (:mod:`mpinets_torch.cli.config`); PyYAML is needed only when
one is given. Without ``--synthetic-data`` the trainer reads the published
dataset layout under ``data.data_dir`` (``{train,val}/*.hdf5``, ``h5py``).
Data parallelism over N cards of a host runs one process a card::

    torchrun --nproc_per_node N -m mpinets_torch.cli.train [jobconfig.yaml] ...

(or ``MPINETS_COORDINATOR=host:port`` with ``WORLD_SIZE`` and ``RANK``);
``optim.batch_size`` is per card.
"""

from __future__ import annotations

import argparse

from mpinets_torch.cli.config import load_config
from mpinets_torch.train.trainer import Trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("yaml_config", nargs="?", default=None)
    parser.add_argument(
        "--test", action="store_true",
        help="smoke mode: 10 train batches, 3 val problems, 1 epoch "
             "(run_training.py:68-70 semantics)",
    )
    parser.add_argument("--no-logging", action="store_true")
    parser.add_argument("--no-checkpointing", action="store_true")
    parser.add_argument(
        "--synthetic-data", action="store_true",
        help="train on the on-device pseudo-expert generator instead of HDF5 files",
    )
    parser.add_argument(
        "--resume", default=None, metavar="EXP_DIR",
        help="resume from an experiment directory's `last` checkpoint",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    cfg = load_config(args.yaml_config)
    if args.synthetic_data:
        cfg.data.synthetic = True
    if args.resume:
        cfg.resume_from = args.resume
    trainer = Trainer(
        cfg,
        test=args.test,
        should_log=not args.no_logging,
        should_checkpoint=not args.no_checkpointing,
        device=args.device,
    )
    trainer.run()


if __name__ == "__main__":
    main()
