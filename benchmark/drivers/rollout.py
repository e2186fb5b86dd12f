"""Driver ``rollout``: closed-loop lockstep rollouts through the system's
rollout engine, back to back.

Set-up builds the policy at the configuration's widths with weights drawn
from the seed, binds the kernel forward
(``model.fused.make_fused_apply(dtype, fast_grouping, sa_impl)``) into
``rollout.engine.make_rollout_fn`` as batch evaluation runs it, draws a
pool of problem batches from the seed, and warms every shape with a
two-step rollout. The window then runs one ``steps``-step rollout after
another, each on a fresh batch and with its own generator for the cloud's
draws, each ended by a device sync, until ``seconds`` have passed; its rate
is every env-step of every rollout over the whole window.

At t = 0 and at one later step drawn from the seed, every rollout keeps
the policy's input cloud and configuration and the outputs of each stage
(FPS picks, ball-query selections, SA features) and the Delta-q, as the
kernel wrappers returned them; after the window one rollout, drawn from
the seed, is held against the reference (:mod:`benchmark.reference.check`).
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import counts, generate, weights as weights_mod
from benchmark.reference import check, policy

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Wraps the system's FPS and SA-stage entry points so that, while armed,
    their outputs are kept in call order; unarmed it only passes through."""

    NAMES = ("furthest_point_sample_with_coords", "sa_stage")

    def __init__(self, ops):
        self.armed = None
        self.ops = ops
        self.orig = {name: getattr(ops, name) for name in self.NAMES}
        for name, fn in self.orig.items():
            setattr(ops, name, self._wrap(name, fn))

    @staticmethod
    def forward(rec, cloud, q_norm, dq):
        """One policy call's record, as :func:`check.policy_numbers` reads it:
        its input, FPS picks, ball-query selections, SA features and Delta-q."""
        (_, fps0), (_, sa0), (_, fps1), (_, sa1) = rec
        return dict(cloud=cloud, q_norm=q_norm, fps0=fps0[0], sel0=sa0[1], f0=sa0[0].detach(),
                    fps1=fps1[0], sel1=sa1[1], f1=sa1[0].detach(), dq=dq)

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed is not None:
                self.armed.append((name, out))
            return out
        return wrapped


def scale_decoder_out(weights, cfg, scale):
    """The decoder's last layer (weight and bias) times ``scale``. At
    nn.Linear's range a random policy outputs nearly one Delta-q for every
    problem and step (about 0.06 a joint, normalized), so each robot of a run
    reaches the corner of the joint box that the seed's weights point to
    within some 30 steps, and that corner sets the ball query's work. Scaled
    down, the robots stay near their own start poses, drawn from the seed
    like a trained policy's starts and goals, and every seed gets the same
    spread of poses."""
    last = f"decoder_{len(cfg['decoder']) - 1}"
    for name in (f"{last}.weight", f"{last}.bias"):
        weights[name] = weights[name] * scale
    return weights


def _problem(p, program):
    Problem, SceneSet = program["Problem"], program["SceneSet"]
    scene = SceneSet(*(p[f] for f in SceneSet._fields))
    return Problem(p["q0"], p["target_rot"], p["target_trans"], scene)


def _program():
    """The system under test, imported only here."""
    from mpinets_torch.data.synthetic import Problem
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.kernels import ops
    from mpinets_torch.model import fused
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.rollout import engine
    return dict(Problem=Problem, SceneSet=SceneSet, ops=ops, fused=fused,
                MotionPolicyNetwork=MotionPolicyNetwork, engine=engine)


class Driver:
    """One cell's rollouts: ``setup``, ``window``, ``release``, ``numbers``."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch, self.steps = traffic["batch"], traffic["steps"]
        self.rng = random.Random(generate.subseed(seed, "sample"))
        self.to_engine = None    # a planted fault's view of Delta-q (benchmark.faults)

    def setup(self):
        cfg, dev = self.cfg, self.device
        if not cfg["tf32"]:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        program = self.program = _program()
        self.recorder = Recorder(program["ops"])
        self.weights = scale_decoder_out(weights_mod.make(cfg, self.seed, dev), cfg,
                                         self.traffic["decoder_out_scale"])
        model = program["MotionPolicyNetwork"](
            compute_dtype=DTYPES[cfg["compute_dtype"]],
            sa_npoints=(cfg["sa0"]["npoint"], cfg["sa1"]["npoint"]),
            sa_nsamples=(cfg["sa0"]["nsample"], cfg["sa1"]["nsample"]),
            sa_radii=(cfg["sa0"]["radius"], cfg["sa1"]["radius"]), device=dev)
        model.load_state_dict(self.weights, strict=True)
        model.requires_grad_(False)
        self.model = model
        apply = program["fused"].make_fused_apply(
            DTYPES[cfg["compute_dtype"]], fast_grouping=cfg["fast_grouping"],
            sa_impl=cfg["sa_impl"])
        self.capture_at = None   # the steps to keep, set a rollout at a time
        self.step = 0

        def observed(m, xyz, q_norm):
            keep = self.capture_at is not None and self.step in self.capture_at
            if keep:
                self.recorder.armed = []
                cloud = xyz.clone()
            dq = apply(m, xyz, q_norm)
            if keep:
                rec, self.recorder.armed = self.recorder.armed, None
                self.caps.append((self.step, self.recorder.forward(rec, cloud, q_norm, dq)))
            self.step += 1
            return dq if self.to_engine is None else self.to_engine(dq)

        engine = program["engine"]
        sizes = engine.PointCloudSizes(**cfg["points"])
        kw = dict(sizes=sizes, stop_on_success=self.traffic["stop_on_success"],
                  record_trajectory=self.traffic["record_trajectory"], apply_fn=observed,
                  device=dev)
        self.rollout = engine.make_rollout_fn(model, max_steps=self.steps, **kw)
        g = generate.generator(self.seed, "problems", dev)
        self.pool = [generate.problems(g, self.traffic, dev)
                     for _ in range(self.traffic["pool"])]
        warm = engine.make_rollout_fn(model, max_steps=2, **kw)
        warm(_problem(self.pool[0], program), generate.generator(self.seed, "warm", dev))
        sync(dev)

    def _one(self, i):
        """Rollout ``i`` of the window, ended by a device sync."""
        self.step, self.caps = 0, []
        self.capture_at = (0, self.rng.randrange(1, self.steps))
        p = self.pool[i % len(self.pool)]
        res = self.rollout(_problem(p, self.program),
                           generate.generator(self.seed, f"rollout{i}", self.device))
        sync(self.device)
        self.capture_at = None
        return res, p

    def window(self, seconds, profile_first=None):
        """Rollouts until ``seconds`` have passed. ``profile_first(run)`` wraps
        the first rollout (the traced run's profiler). -> {"env_steps_per_s":
        every env-step of the window over its wall time}."""
        self.done, self.sample, self.unit_s = [], None, []
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() - t0 < seconds:
            t_unit = time.perf_counter()
            if i == 0 and profile_first is not None:
                res, p = profile_first(lambda: self._one(0))
                self.traced_caps = self.caps
            else:
                res, p = self._one(i)
            self.unit_s.append(time.perf_counter() - t_unit)
            self.done.append((res.trajectories, res.success, res.num_steps, p))
            if self.rng.random() * (i + 1) < 1.0:          # a uniform draw among the finished
                self.sample = dict(traj=res.trajectories, problem=p, caps=self.caps)
            i += 1
        elapsed = time.perf_counter() - t0
        self.rollouts = i
        self.attempted, self.failed = i * self.batch, 0
        return {"env_steps_per_s": i * self.batch * self.steps / elapsed}

    def release(self):
        """Free the program's state before the reference runs."""
        self.recorder.restore()
        del self.model, self.rollout
        torch.cuda.empty_cache()

    def numbers(self):
        nums, aside, self.refs = check.rollout_numbers(self.cfg, self.weights, self.sample,
                                                       self.done)
        return nums, {"status_set_aside": aside, "rollouts": self.rollouts,
                      "rollout_s": self.unit_s}

    def control_numbers(self, precision):
        """The control's numbers on the sampled rollout's kept steps: the
        reference in ``precision`` against the float32 reference."""
        nums = {}
        for t, cap in self.sample["caps"]:
            got = check.control_numbers(self.cfg, self.weights, cap, self.refs[t], precision)
            nums = {k: max(v, nums.get(k, 0.0)) for k, v in got.items()}
        return nums

    def traced_unit(self):
        """What the per-layer metrics read of the traced (first) rollout
        besides the trace (:func:`benchmark.run.trace_context`): its policy
        steps, the work of its kept steps by the reference's ball query
        (``counts.step_work``), and the median time of the window's untraced
        rollouts (None where the window ran no more)."""
        work = []
        for t, cap in self.traced_caps:
            ref = self.refs.get(t) if self.sample["caps"] is self.traced_caps else None
            if ref is None:
                ref = policy.forward(self.weights, self.cfg, cap["cloud"], cap["q_norm"])
            work.append(counts.step_work(self.cfg, self.batch, ref["count0"], ref["tests0"],
                                         ref["count1"], ref["tests1"]))
        rest = self.unit_s[1:]
        return dict(batch=self.batch, steps=self.steps, work=work,
                    unit_s=statistics.median(rest) if rest else None)
