"""Driver ``train``: behaviour-cloning train steps as the trainer's synthetic
mode runs them.

Set-up builds the policy at the configuration's widths with weights drawn
from the seed, the optimizer (``learner.make_optimizer``: global-norm clip,
then Adam) and the step (``learner.make_train_step`` with the kernel train
forward, ``model.fused_train.make_fused_train_apply``), and drives that one
step object through its first ``first_steps`` steps, which also warm every
shape. Each step's batch is drawn on the card from the seed
(:func:`benchmark.generate.training_draws`) and built by the system's
``data.synthetic.training_batch(draws=...)``. The window then runs the same
feed and step until ``seconds`` have passed and ends in a device sync; its
rate is every sample of every step over the whole window, batch building
included.

After the window the reference follows the first steps from the same
weights, on the batches the program built, and builds each batch again from
its draws to hold the program's against (:mod:`benchmark.reference.train`).
"""

from __future__ import annotations

import time

import torch

from benchmark import counts, generate, weights as weights_mod
from benchmark.drivers.rollout import DTYPES, Recorder, sync
from benchmark.reference import check, policy
from benchmark.reference import train as reference

def _program():
    """The system under test, imported only here."""
    from mpinets_torch.data import synthetic
    from mpinets_torch.geom.assembly import PointCloudSizes
    from mpinets_torch.geom.scene import ObstacleDraws, SceneSet
    from mpinets_torch.model import fused_train
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.train import learner
    return dict(synthetic=synthetic, PointCloudSizes=PointCloudSizes, ObstacleDraws=ObstacleDraws,
                SceneSet=SceneSet, fused_train=fused_train, learner=learner,
                MotionPolicyNetwork=MotionPolicyNetwork)


class Driver:
    """One cell's train steps: ``setup``, ``window``, ``release``, ``numbers``."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.train = cfg["train"]
        self.batch = traffic["batch"]

    def feed(self, i, keep=None):
        """Step ``i``'s batch: draws from the seed, built by the system."""
        p = self.program
        d = generate.training_draws(generate.generator(self.seed, f"batch{i}", self.device),
                                    self.traffic, self.cfg, self.device)
        if keep is not None:
            keep.append(d)
        draws = p["synthetic"].TrainingDraws(
            p["SceneSet"](*(d["scene"][f] for f in p["SceneSet"]._fields)), d["q0"],
            d["q_goal"], d["t"], d["noise"], d["robot_indices"],
            p["ObstacleDraws"](**d["obstacle"]))
        return p["synthetic"].training_batch(
            batch_size=self.batch, sizes=self.sizes, random_scale=self.traffic["random_scale"],
            device=self.device, draws=draws)

    def setup(self):
        cfg, dev, tr = self.cfg, self.device, self.train
        if not cfg["tf32"]:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        p = self.program = _program()
        self.recorder = Recorder(p["fused_train"].ops)
        self.sizes = p["PointCloudSizes"](**cfg["points"])
        self.weights = weights_mod.make(cfg, self.seed, dev)
        cdt = DTYPES[cfg["compute_dtype"]]
        model = p["MotionPolicyNetwork"](
            compute_dtype=cdt, sa_npoints=(cfg["sa0"]["npoint"], cfg["sa1"]["npoint"]),
            sa_nsamples=(cfg["sa0"]["nsample"], cfg["sa1"]["nsample"]),
            sa_radii=(cfg["sa0"]["radius"], cfg["sa1"]["radius"]), device=dev)
        model.load_state_dict(self.weights, strict=True)
        learner = p["learner"]
        opt = learner.make_optimizer(model.parameters(), tr["learning_rate"], tr["grad_clip"])
        self.state = learner.init_state(model, opt)
        apply = p["fused_train"].make_fused_train_apply(cdt, sa_impl=cfg["sa_impl"])

        def observed(m, xyz, q_norm):
            keep = self.recorder.armed is not None
            dq = apply(m, xyz, q_norm)
            if keep:
                rec, self.recorder.armed = self.recorder.armed, None
                self.first["forward"] = Recorder.forward(rec, xyz, q_norm, dq.detach())
            if self.first is not None and len(self.first["dq"]) < self.traffic["first_steps"]:
                self.first["dq"].append(dq.detach().clone())
            return dq

        self.first = None
        self.step = learner.make_train_step(tr["point_match_weight"], tr["collision_weight"],
                                            apply_fn=observed)
        # the first steps, through the window's own feed and step
        self.first = {"point_match": [], "collision": [], "draws": [], "batches": [], "dq": []}
        named = dict(model.named_parameters())
        for i in range(self.traffic["first_steps"]):
            self.recorder.armed = [] if i == 0 else None   # the first step's forward
            b = self.feed(i, self.first["draws"])
            self.first["batches"].append(b)
            self.state, metrics = self.step(self.state, b)
            self.first["point_match"].append(metrics["point_match_loss"])
            self.first["collision"].append(metrics["collision_loss"])
            if i == 0:
                b1 = opt.param_groups[0]["b1"]
                self.first["grad"] = {k: opt.state[v]["mu"].detach() / (1 - b1)
                                      if "mu" in opt.state[v] else torch.zeros_like(v)
                                      for k, v in named.items()}
        self.first["params"] = {k: v.detach().clone() for k, v in named.items()}
        sync(dev)
        self.first["point_match"] = [float(x) for x in self.first["point_match"]]
        self.first["collision"] = [float(x) for x in self.first["collision"]]

    def window(self, seconds, profile_first=None):
        """Steps until ``seconds`` have passed; ``profile_first(run)`` wraps the
        first ``trace_steps`` (the traced run's profiler). -> {"train_samples_per_s":
        every sample of the window over its wall time}."""
        i = self.traffic["first_steps"]
        steps = 0
        self.traced = []
        t0 = t_rest = time.perf_counter()
        if profile_first is not None:
            def unit():
                for k in range(self.traffic["trace_steps"]):
                    b = self.feed(i + k)
                    self.traced.append(b["xyz"])
                    self.state, _ = self.step(self.state, b)
            profile_first(unit)
            steps = self.traffic["trace_steps"]
            t_rest = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            self.state, _ = self.step(self.state, self.feed(i + steps))
            steps += 1
        sync(self.device)
        t_end = time.perf_counter()
        elapsed, self.untraced_s = t_end - t0, t_end - t_rest
        self.attempted, self.failed, self.steps_run = steps * self.batch, 0, steps
        return {"train_samples_per_s": steps * self.batch / elapsed}

    def release(self):
        """Free the program's state before the reference runs."""
        self.recorder.restore()
        del self.state, self.step
        torch.cuda.empty_cache()

    def _reference(self, precision="f32"):
        """The reference's steps on the batches the program built (each held
        against the reference's own build of its draws by ``batch_err``: a
        cloud one rounding apart can move an FPS pick, and with it every
        later stage, on either side)."""
        return reference.follow(self.weights, self.cfg, self.train, self.first["batches"],
                                precision)

    def numbers(self):
        self.ref = self._reference()
        nums, info = reference.train_numbers(self.cfg, self.train, self.weights, self.ref,
                                             self.first)
        built = [reference.batch(d, self.cfg, self.traffic) for d in self.first["draws"]]
        nums["batch_err"] = reference.batch_err(self.first["batches"], built)
        fwd, first = self.first["forward"], self.first["batches"][0]
        forward, self.ref_forward = check.policy_numbers(self.cfg, self.weights, fwd)
        nums.update(forward)
        # the forward ran on the whole batch the feed built
        nums["input_mismatch"] = sum(
            int((a != b).sum()) if a.shape == b.shape else b.numel()
            for a, b in ((fwd["cloud"], first["xyz"]), (fwd["q_norm"], first["configuration"])))
        return nums, dict(info, steps=self.steps_run,
                          first_losses=[self.first["point_match"], self.first["collision"]])

    def control_numbers(self, precision):
        """The control's numbers: the reference in ``precision`` followed from
        the same weights and draws, against the float32 reference."""
        low = self._reference(precision)
        nums, _ = reference.train_numbers(self.cfg, self.train, self.weights, self.ref, low)
        nums.update(check.control_numbers(self.cfg, self.weights, self.first["forward"],
                                          self.ref_forward, precision))
        return nums

    def traced_unit(self):
        """What the per-layer metrics read of the traced steps besides the
        trace (:func:`benchmark.run.trace_context`): the policy steps they
        ran, the work of each by the reference's ball query on its cloud
        (``counts.step_work``: the forward's), and the seconds the same
        number of steps took untraced, by the mean over the rest of the
        window (None where the window ran no more)."""
        work = []
        for xyz in self.traced:
            ref = policy.forward(self.weights, self.cfg, xyz, torch.zeros(
                xyz.shape[0], self.cfg["dof"], device=xyz.device))
            work.append(counts.step_work(self.cfg, self.batch, ref["count0"], ref["tests0"],
                                         ref["count1"], ref["tests1"]))
        rest = self.steps_run - len(self.traced)
        unit_s = self.untraced_s / rest * len(self.traced) if rest > 0 else None
        return dict(batch=self.batch, steps=len(self.traced), work=work, unit_s=unit_s)
