"""The port's spans (``mpinets_torch/utils/trace.py``).

With no profiler running nothing is recorded and a rollout's outputs are the
same bit for bit; under ``torch.profiler`` a CPU rollout records
``rollout.policy`` and ``rollout.env`` once a step with ``policy.tail``
inside the policy's span, a train step ``train.batch`` and ``train.step``,
and no ``wait.*`` (on the CPU nothing waits). The ``cuda`` tests hold, on
the card, that a warm rollout step makes no copy from the host and no wait
(its tables are on the card since the warm-up), that every device operation
of a step lies under exactly one of its two spans, and that a warm rollout
never synchronises with the card. The file imports no JAX:

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpinets_torch.data import synthetic
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.fused_train import make_fused_train_apply
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.rollout import engine
from mpinets_torch.train import learner
from mpinets_torch.utils import trace

NPOINTS = (16, 8)
SIZES = PointCloudSizes(64, 48, 16)
STEPS = 3
SPANS = {"rollout.policy", "rollout.env", "policy.tail", "train.batch", "train.step"}
#: The copies from the host a warm rollout step makes on a card: none. The
#: joint limits and the point banks are copied once per (table, dtype,
#: device), by the warm-up, and a copy in a step would drain the card's queue.
STEP_WAITS = []


def small_rollout(device="cpu", npoints=NPOINTS, sizes=SIZES, batch=2, dtype=torch.float32):
    model = MotionPolicyNetwork(compute_dtype=dtype, sa_npoints=npoints, device=device,
                                generator=torch.Generator().manual_seed(0)).eval()
    run = engine.make_rollout_fn(model, max_steps=STEPS, sizes=sizes, device=device,
                                 apply_fn=make_fused_apply(dtype))
    problem = synthetic.random_problem_batch(torch.Generator(device).manual_seed(1), batch,
                                             device=device)
    return lambda: run(problem, torch.Generator(device).manual_seed(2))


def profiled(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    return out, prof.events()


def spans_of(events):
    """The program's ranges: user annotations, host side."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and getattr(e, "is_user_annotation", "::" not in e.name)]


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("rollout.policy") is trace.span("train.step")
    assert trace.h2d_wait("joint_limits", "cuda") is trace.span("rollout.env")
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("rollout.policy") is not trace.span("rollout.policy")
        assert trace.h2d_wait("joint_limits", "cpu") is trace.h2d_wait("point_bank", None)
        assert trace.h2d_wait("joint_limits", "cuda") is not trace.h2d_wait("point_bank", "cpu")


def test_rollout_records_nothing_and_is_bit_identical_without_a_profiler(monkeypatch):
    run = small_rollout()
    calls = []
    monkeypatch.setattr(trace, "record_function", lambda name: calls.append(name))
    plain = run()
    assert calls == []
    monkeypatch.undo()
    traced, _ = profiled(run)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_cpu_rollout_records_each_step_and_no_wait():
    _, events = profiled(small_rollout())
    names = [e.name for e in spans_of(events)]
    assert names.count("rollout.policy") == names.count("rollout.env") == STEPS
    assert names.count("policy.tail") == STEPS
    for e in events:
        if e.name == "policy.tail":
            assert e.cpu_parent.name == "rollout.policy"
    assert not [n for n in names if n.startswith("wait.")]
    assert set(names) <= SPANS
    assert not [n for n in names if n.startswith(("cu", "bench."))]


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_train_step_records_batch_and_step(fused):
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    state = learner.init_state(model)
    step = learner.make_train_step(apply_fn=make_fused_train_apply(torch.float32)
                                   if fused else None)

    def one():
        batch = synthetic.training_batch(torch.Generator().manual_seed(3), 2, SIZES)
        return step(state, batch)

    _, events = profiled(one)
    names = [e.name for e in spans_of(events)]
    assert names.count("train.batch") == names.count("train.step") == 1
    assert not [n for n in names if n.startswith(("wait.", "cu", "bench."))]
    # torch.optim records its own ranges (``Optimizer.step#ClippedAdam.step``)
    assert {n for n in names if not n.startswith("Optimizer.")} <= SPANS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda", 0)


def launches(events):
    """(launch call's host start, device operation's name) of each device
    operation, matched to its runtime call by correlation id: the hand
    kernels' ``ctypes`` launches run under no torch op, so the profile does
    not attach them to the range open at their launch."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    at = {e.id: e.time_range.start for e in events
          if e.device_type == cpu and e.name.startswith("cu")}
    return [(at[e.id], e.name) for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False) and e.id in at]


def within(t, e):
    return e.time_range.start <= t <= e.time_range.end


def card_rollout(card):
    return small_rollout(card, npoints=(512, 128), sizes=PointCloudSizes(), batch=8,
                         dtype=torch.bfloat16)


@pytest.mark.cuda
def test_card_rollout_makes_no_wait_and_each_op_lies_under_one_span(card):
    run = card_rollout(card)
    run()                                     # builds the kernels, copies the tables
    _, events = profiled(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    host = spans_of(events)
    steps = sorted((e for e in host if e.name in ("rollout.policy", "rollout.env")),
                   key=lambda e: e.time_range.start)
    assert len(steps) == 2 * STEPS
    ops = launches(events)
    for env in (e for e in steps if e.name == "rollout.env"):
        inside = [e.name for e in host if e.name.startswith("wait.")
                  and within(e.time_range.start, env)]
        assert inside == STEP_WAITS
        copies = [name for t, name in ops if within(t, env) and "HtoD" in name]
        assert copies == [], copies
    first, last = steps[0].time_range.start, steps[-1].time_range.end
    by_span = {"rollout.policy": set(), "rollout.env": set()}
    for t, name in ops:
        if first <= t <= last:
            owners = [e.name for e in steps if within(t, e)]
            assert len(owners) == 1, (name, owners)
            by_span[owners[0]].add(name)
    policy = " ".join(by_span["rollout.policy"])
    for name in ("sa_kernel_mma", "sa_select_kernel", "fps_kernel"):
        assert name in policy, sorted(by_span["rollout.policy"])
    assert not [k for k in by_span["rollout.env"] if "sa_" in k or "fps" in k]


@pytest.mark.cuda
def test_card_rollout_never_synchronises(card):
    run = card_rollout(card)
    run()
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")   # a synchronising call raises
    try:
        result = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(card)
    assert result.trajectories.shape == (8, STEPS + 1, 7)
