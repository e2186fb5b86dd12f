"""One rank of a two-process gloo run of ``mpinets_torch`` on the CPU.

    python tests/torch_dist_worker.py TASK RANK WORLD WORKDIR

The ranks meet through ``file://WORKDIR/rendezvous*`` files, so parallel
test workers never share a port. This script imports only the port (never
JAX): the tests that start it hold what it writes against the JAX package.

Tasks:

* ``parity``: reads ``WORKDIR/inputs.pt`` (weights, a global batch, a raw
  batch and each rank's draws, validation problems) and writes
  ``WORKDIR/out_RANK.pt``: the data-parallel step (plain, and with
  ``prepare_train_batch`` on this rank's draws), the sharded rollout on
  this rank's block, the plain rollout on the same block with the rank's
  generator, the sharded success statistics on given draws, and
  ``process_local_slice``.
* ``trainer``: reads ``WORKDIR/config.json`` (overrides of
  :func:`mpinets_torch.cli.config.load_config`), runs the trainer (10
  steps, ``--test``), then resumes from rank 0's ``last`` checkpoint, and
  writes each run's final parameters, step and directory.
"""

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

torch.set_num_threads(2)
torch.set_float32_matmul_precision("highest")


def _model(state_dict, cfg_model):
    from mpinets_torch.model.policy import MotionPolicyNetwork

    model = MotionPolicyNetwork(device="cpu", **cfg_model)
    model.load_state_dict(state_dict)
    return model


def parity(rank, world, workdir):
    import functools

    from mpinets_torch.data import hdf5
    from mpinets_torch.data.synthetic import Problem
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.parallel import mesh as pmesh
    from mpinets_torch.parallel import rollout as prollout
    from mpinets_torch.rollout.engine import make_rollout_fn
    from mpinets_torch.train import learner

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    pmesh.multihost_init(f"file://{workdir}/rendezvous", world, rank, device="cpu")
    mesh = pmesh.make_mesh(world)
    out = {}

    def run_step(step_fn, *args):
        model = _model(inp["state_dict"], inp["model"])
        state = learner.init_state(model)
        state, metrics = step_fn(state, *args)
        return {k: v.clone() for k, v in model.state_dict().items()}, {
            k: float(v) for k, v in metrics.items()}

    out["plain"] = run_step(learner.make_data_parallel_step(mesh),
                            learner.shard_batch(inp["batch"], mesh))
    prepare = functools.partial(hdf5.prepare_train_batch, sizes=inp["sizes"])
    out["prepare"] = run_step(learner.make_data_parallel_step(mesh, prepare_fn=prepare),
                              learner.shard_batch(inp["raw"], mesh), inp["prepare_draws"][rank])

    p = inp["problems"]
    problems = Problem(p["q0"], p["target_rot"], p["target_trans"], SceneSet(*p["scene"]))
    model = _model(inp["state_dict"], inp["model"]).eval()
    kwargs = dict(max_steps=inp["rollout_steps"], sizes=inp["sizes"], stop_on_success=True)
    sharded = prollout.make_sharded_rollout(model, mesh, device="cpu", **kwargs)
    out["rollout"] = sharded(problems, 11)
    block = pmesh.shard_leading_axis(problems, mesh)
    out["rollout_plain"] = make_rollout_fn(model, device="cpu", **kwargs)(
        block, torch.Generator().manual_seed(pmesh.fold_seed(11, rank)))
    stats = prollout.make_sharded_success_stats(
        model, mesh, sizes=inp["sizes"], max_steps=inp["stats_steps"], device="cpu")
    init_cloud, robot_indices = inp["stats_draws"][rank]
    out["stats"] = {k: float(v) for k, v in stats(problems, 0, init_cloud, robot_indices).items()}

    out["local_slice"] = pmesh.process_local_slice(8)
    try:
        pmesh.process_local_slice(7)
    except ValueError as e:
        out["local_slice_error"] = str(e)
    out["data_sharding"] = tuple(pmesh.data_sharding(mesh))
    torch.save(out, workdir / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()


def trainer(rank, world, workdir):
    from mpinets_torch.cli.config import load_config
    from mpinets_torch.train.trainer import Trainer

    overrides = json.loads((workdir / "config.json").read_text())
    synthetic = overrides.pop("synthetic", False)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    out = []
    resume = ""
    for run in range(2):
        os.environ["MPINETS_COORDINATOR"] = f"file://{workdir}/rendezvous_{run}"
        cfg = load_config(None, dict(overrides, resume_from=resume))
        cfg.data.synthetic = synthetic
        trainer = Trainer(cfg, test=True, device="cpu")
        state = trainer.run()
        assert not torch.distributed.is_initialized()
        out.append({"step": state.step, "ckpt_dir": str(trainer.ckpt_dir),
                    "global_batch": trainer.global_batch,
                    "params": {k: v.clone() for k, v in state.model.state_dict().items()}})
        resume = str(trainer.ckpt_dir)
    torch.save(out, workdir / f"out_{rank}.pt")


def launch(task, workdir, world=2, timeout=240):
    """Start ``task`` on ``world`` ranks, each a subprocess of this script;
    -> ``wait()``, which returns each rank's output (``WORKDIR/out_RANK.pt``)
    and fails if a rank failed or outlived ``timeout`` seconds."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MPINETS_COORDINATOR")}
    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    return lambda: _wait(procs, workdir, timeout)


def _wait(procs, workdir, timeout):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(Path(workdir) / f"out_{r}.pt", weights_only=False)
            for r in range(len(procs))]


if __name__ == "__main__":
    task, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    {"parity": parity, "trainer": trainer}[task](rank, world, workdir)
