#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpinets_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mpinets_torch/csrc/`` (logging each SA,
FPS and probe instantiation's registers and spills, failing on a spill --
every SA, FPS, scan, roll and micro-op instantiation is gated -- and the
launch plans, counting the tensor-core ``HMMA`` instructions in the built
SASS where the toolkit has ``cuobjdump``, and failing unless the roll's rep
loop at the probe session's rb issues one FADD a held row for each SHFL and
bd_matmul's rep loop 97 FADD for each FMUL and no f32/bf16 conversion),
holds each kernel against its plain PyTorch
version at the main path's shapes -- FPS (each plan the main paths use, at
B=1, 3 and 256, on the assembled cloud and on a cloud of exact ties), the
exact ball query (``sa_select``, also at
B=1), the exact SA stage (the ball query, then the MLP kernel reading its
selection), its raw-block output (train path), its off-cloud branch
(``sa_impl="v3"``) and the chunk-window SA0, and every SA variant on a
cloud whose neighbour counts cross the bf16 kernel's 16-row tiles (at SA0
widths, 49 centroids whose packed tiles hold 1 to 16 centroids) and, in f32,
the CUDA-core kernel's 64- and 128-row tiles, each variant bit-equal under
8, 16 and 32 centroids a block, as fits, in both types (also the exact and
fast SA0 at B=256 and SA1 at B=32, timed by centroids per block), the bf16
CUDA-core kernel at layers too wide for the tensor cores' shared memory --
and the train path's parameter gradients, kernels against plain versions,
and the SA backward kernels (``csrc/sa_bwd.cu``, on ``wgmma``; the row
kernel spills at most ``SA_BWD_SPILL`` bytes of per-item scalars) at
B=1, 3 and 64 and at every shape the train paths launched them at,
against their plain version, timed beside their bound, the plain version
and the replay they replaced. It
then checks the
full-width forward against the plain paths and drives, with random weights
made from a seed, each path a user calls: the planning server
(``cli.serve.Planner``, exact grouping), the batched closed-loop rollout
(B=256, ``fast_grouping=4``, timed by long-minus-short, 30 - 5 steps, as
``bench.py`` does), a short rollout through the v3 stage, and the trainer
(``train.trainer.Trainer``, synthetic data, reference widths, bf16, at
B=10 and B=64: steps, validation, checkpoints, a restore, then at least
``TRAIN_MIN_S`` seconds of timed steps in chunks, reported as the median
and range of the chunks' rates; and once at a small cloud, which runs the
kernels as well), ``cli.infer`` in five modes, and scene generation: the
batched IK (``kernels.ik``) on the card against the CPU with the same
draws, captured in a CUDA graph (no host sync) and timed at 320 and 4,096
targets x 16 seeds, then 4 scenes of each environment (``envs``), every
candidate re-checked on the CPU; the expert pipeline (``pipeline``):
``plan_scene`` at gen's defaults on the first kept scene of each
environment, the dresser's again with a PRM seed at full size (peak
memory), card against CPU on 8 tabletop pairs with the same draws, the
busy share of one ``plan_scene``, and ``gen`` (2 tabletop scenes held out
for the problem pickle, read back and checked against the FK); the DAgger
actors: the trainer's actor mode (synthetic data, reference widths, bf16,
collects at steps 3, 6 and 9, each launching the kernels) and the real
collector at B=16 on the expert phase's trajectories; data-parallel
training on the dataset layout: a process group of world size 1 on NCCL
(``parallel.mesh.multihost_init``), train and validation splits in the
disk schema from the expert phase's trajectories, ``InstanceLoader`` ->
``prepare_train_batch`` on the card (held against the CPU on the same
draws) -> ``make_data_parallel_step`` with the kernel forward at B=10 and
64 (timed beside ``make_train_step`` on the same batch; an f32 DP step's
gradients held against it), the all-reduce timed alone,
``make_sharded_success_stats`` on the validation split (held against the
plain rollout on the same draws), one hdf5-actor collect and its DP step,
and ``Trainer.run`` in hdf5 mode where ``h5py`` imports. After the
evaluation come the real weights: the committed orbax checkpoint
``checkpoints/r5_ft_best_ema`` read without JAX through
``cli.infer.load_params``, the forward at full widths (B=8) held against
the plain versions (f32 kernel path against the plain policy within 2e-5 +
1e-4 x |dq|, bf16 kernel path against its plain path within 2% of max
|dq|), ``cli.serve --checkpoint`` answering 3 requests, ``cli.infer`` on the
evaluation's 64 problems in bf16 exact and ``--fp32`` (seconds and success
share printed; ``fps``, ``sa_select``, ``sa`` and ``sa_f32`` launched), and
``python -m mpinets_torch.eval.compare`` on a run's metric pickle against
itself (exit 0, a gate) and on bf16 against ``--fp32`` (its report
printed, a measurement); then the evaluation extras: ``eval.calibration``
at 2,048 samples with the bank proxy, and with the hull proxy at inflates
0.9, 1.0 and 1.1 on a synthetic gripper mesh the script writes (a check of
the code path; a missing mesh must be refused), each on the card and on the
CPU with the same draws (flags equal wherever a clearance is more than 1e-5
from its threshold; summaries and both times printed), and ``gen tabletop
--visualize-scene`` on the card, whose page's spheres and end-effector path
must lie within 1e-4 of the CPU's FK of the same trajectory. Last it drives
the TPU probe session
(``mpinets_torch.probes.session``, what ``python -m mpinets_torch.probes``
runs): each probe kernel of ``csrc/probes.cu`` against its plain version at
the scripts' full shapes, on the scan's edge cases and on a cloud whose
centroids pass 128 hits early, then timed by the scripts' long-minus-short
loop, with SA0 exact timed beside the scan stages; each scan mode's time is
printed beside its bound, the share of it reached, its time recorded
before the redesign (``SCAN_WAS_MS``; the log line only), and its
instantiation's registers, spills and blocks a SM (a spill fails the build
phase); each micro op (gather, the rolls, vadd, bd_matmul) at 8 and 32 reps
the same way (its kernel's registers, spills, blocks a SM, threads and
shared memory at the session's rb), and roll_narrow and the scratch probe
beside the session's launch floor (``launch_floor_ms``: an empty kernel,
``probe_empty_kernel``, timed in the same loop), which must be above 0 and
below every probe's time. The session also checks the micro ops at
other layouts (``session.MICRO_EDGE_CASES``: a ragged last thread, rings
over several warps, reps 0). Bounds count uncontracted f32 operations at
the card's non-FMA rate (``session.F32_NOFMA_OPS``) and gather's
shared-memory reads at 32 words a clock a SM (``session.SMEM_WORDS_PER_S``).
Then it times every kernel at each (batch, cloud, centroids) shape the main
paths launched it at, against its plain version there, with its bound from
that input's data, and prints launches x (ms - bound ms) summed over each
kernel's shapes; then the f32 CUDA-core MLP (``sa_f32``) at B=1, 3, 32 and
256 the same way, beside three cuBLAS f32 products over its packed rows,
and its fast SA0 and v3 variants at B=32 and 256.
Last, the port bench (``python -m mpinets_torch.bench``, called in-process
at its defaults, ``--fast-grouping 0``, ``--sa-impl v3``, ``--sweep`` and
``--profile``): each run's last line checked (a rate above 0, its config,
the card) and its kernels launched, every kernel held against its plain
version at each shape the sweep launched that no main path did (B=512, and
B=64 outside the train path), its launches kept out of the main paths'.

Any failed phase raises, so the script exits non-zero. It also exits
non-zero, printing no result, when there is no CUDA device or when the
``mpinets_torch`` package is not beside it. Launch counts are set to 0
before each main path and read after it. The line before the last is a
JSON object with one entry per kernel and (B, N, S) the main paths launched
it at: ``ms`` times the kernel alone (an SA MLP kernel on the exact path
reading a given selection; ``cpb``, its plan's centroids per block),
``launches`` counts that kernel at that shape
over the main paths (an FPS entry also has its ``plan``, [threads, points a
thread, cluster], and ``ns_per_pick``, ``ms`` over npoint - 1 picks);
a probe kernel has one entry per timed probe of the session (a scan mode
stands for every TPU script probe that computes the same function), its
launches in the timed runs of the probe session; a scan mode's entry also
has this run's ``bound_share``, ``registers``, ``spills``,
``blocks_per_sm`` and ``smem_bytes``, and a micro op's this run's
``bound_share``, ``registers`` and ``spills``. A probe's ``bound_ms`` and
``bound_by`` are its bytes or operations bound; ``launch_floor_ms`` is the
session's launch floor, and ``bound_share`` is the larger of the two over
``ms``.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_sa_cases import exact_mlp, grid_cloud, rel_l2  # noqa: E402  (shared with the tests)

SEED = 0
B = 256
FAST_W = 4
STEPS_SHORT, STEPS_LONG = 5, 30
V3_STEPS = 5              # the rollout through the v3 stage
TRAIN_BATCHES = (10, 64)  # the reference per-device batch (config.py:45), and a larger one
TRAIN_MIN_S = 5.0         # seconds of timed train steps per batch size and rate
TRAIN_CHUNK = 5           # train steps per timed chunk
GRAD_B = 8                # batch of the train-gradient check
SA_BWD_BATCHES = (1, 3, 64)  # the SA backward kernels' timed batches (the train cell's: 64)
PLAIN_ROWS = 16           # rows per plain-version call, to bound its memory
SPREAD = (0, 1, 15, 16, 17, 31, 127, 128, 200)  # neighbours per centroid, across the tiles
# SA0's spread: 49 centroids, so packed tiles of 16 rows hold 1 to 16
# centroids in blocks of 8, 16 and 32 (tests/test_torch_cuda.py's SPREAD_SA0)
SPREAD_SA0 = (0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 1, 0, 0, 1, 128,
              2, 3, 5, 13, 15, 16, 17, 31, 200, 3, 5, 2, 1, 0, 13, 16,
              17, 31, 15, 16, 0, 1, 2, 3, 5, 13, 1, 1, 128, 0, 200, 3)
# the CUDA-core kernel's row tiles (64 and 128 rows): counts 0, 1, tile - 1,
# tile, tile + 1 and 128, packed so that tile edges fall inside and between
# centroids in blocks of 8, 16 and 32 (tests/test_torch_cuda.py's SPREAD_TILES)
SPREAD_TILES = (1, 63, 0, 65, 60, 0, 0, 128, 127, 1, 64, 1, 2, 17, 31, 1, 64, 63, 200, 1, 0,
                13, 62, 64, 1, 2, 127, 128, 33, 65, 5, 129, 3)
SA_MAIN_BATCHES = (1, 3, 10, 64, 256)   # the batches the main paths run the SA stages at
F32_TOL = 1e-5            # kernel vs plain, f32: sums in another order
BF16_TOL = 1e-2           # kernel vs plain, bf16: a 1-ulp flip of a bf16 activation
FWD_F32_TOL = 2e-5        # full forward, kernel path vs plain policy, f32
FWD_BF16_TOL = 2e-2       # full forward, kernel path vs plain path, bf16 (relative to max |dq|)
# train gradients, kernels vs plain versions, per tensor: f32 element-wise as
# the CPU tests (test_fused_train.py); bf16 by relative L2 distance. Two bf16
# runs that round in different places are each about the bf16-to-f32
# distance from the f32 gradients, so sqrt(2) times it from each other. The
# loss's collision hinge and the max-pools turn a one-ulp flip of the
# forward into a shift of the whole cotangent, about the same share of every
# tensor downstream (1.8% on this input), while one tensor's own bf16-to-f32
# distance can be smaller by chance; so a tensor's gate takes the larger of
# its own and the whole policy's bf16-to-f32 distance.
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
BF16_GRAD_FACTOR = 2 ** 0.5
# the SA backward kernel vs its plain version, relative L2 per output, under
# exact_mlp weights: one term an output, or SA_BWD_TERMS on a grid cloud,
# where every sum of the forward is exact in any order. Under dense weights
# a row's bf16 activations round apart where its f32 sums do, and rows near
# a max swap: those are held as the train gradients are (BF16_GRAD_FACTOR).
SA_BWD_TOL = 1e-4
SA_BWD_TERMS = 8
SA_BWD_SPILL = 16  # bytes the SA backward's row kernel may spill (per-item scalars)

# H100 SXM peak of the bf16 tensor cores (NVIDIA data sheet, dense); those of
# HBM and the f32 CUDA cores are mpinets_torch.probes.session's.
BF16_FLOPS = 989e12

TPU_SOURCES = {
    "fps": "mpinets_tpu/kernels/pallas_ops.py:32",
    "sa_select": "mpinets_tpu/kernels/pallas_ops.py:749",   # its scan, :814-891
    "sa": "mpinets_tpu/kernels/pallas_ops.py:749",
    "sa_raw": "mpinets_tpu/kernels/pallas_ops.py:749",
    "sa_v3": "mpinets_tpu/kernels/pallas_ops.py:267",
    "sa_fast": "mpinets_tpu/kernels/pallas_ops.py:989",
    "sa_bwd": None,  # the JAX package's SA backward is plain XLA (model/fused_train.py:128-188)
}
# The TPU probe kernels. One CUDA kernel serves several TPU probes, so each
# probe's record from mpinets_torch/probes/session.py names the script lines
# it replaces (scripts/onchip_r3b.py:120, onchip_r3c.py:184, onchip_r3d.py:69
# and :175, onchip_r4a.py:71 and :129) and the scripts' measurements it
# stands for.
PROBE_KERNELS = ("probe_scan", "probe_micro", "probe_wide", "probe_scratch")
# The scan probe's times by mode before its redesign (NVIDIA H100 80GB HBM3,
# 700.00 W, B=256, N=6272, S=512; PERF.md's table of TPU kernels). Recorded,
# not measured by this script: only the probe phase's log prints them.
SCAN_WAS_MS = {"hits": 0.3216, "count": 0.6442, "count_noscan": 0.6499, "slot": 1.0581,
               "gather": 0.8160, "tile_sum": 0.8402}
CUDA_SOURCES = {"fps": "mpinets_torch/csrc/fps.cu", "sa_select": "mpinets_torch/csrc/sa.cu",
                "sa": "mpinets_torch/csrc/sa.cu",
                "sa_raw": "mpinets_torch/csrc/sa.cu", "sa_v3": "mpinets_torch/csrc/sa.cu",
                "sa_fast": "mpinets_torch/csrc/sa.cu", "sa_bwd": "mpinets_torch/csrc/sa_bwd.cu",
                **dict.fromkeys(PROBE_KERNELS, "mpinets_torch/csrc/probes.cu")}


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events, after
    one warm-up call. The timed calls are queued behind a device busy-wait,
    so a kernel shorter than its host call is timed on the device."""
    import torch

    from mpinets_torch.probes.session import SLEEP_CYCLES

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def by_rows(fn, *tensors, rows=PLAIN_ROWS):
    """fn over row slices of the batch, outputs concatenated."""
    import torch

    outs = [fn(*(t[i:i + rows] for t in tensors)) for i in range(0, tensors[0].shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


@contextlib.contextmanager
def plain_ops(ops):
    """Route the kernel launches that the train path makes to the plain
    versions, on any device (the plain reference of the kernels).
    ``sa_stage`` stays, so its mapping of ``impl`` and ``centroids_in_cloud``
    onto the kernel is compared too."""
    with mock.patch.object(ops, "sa_kernel", ops.sa_plain), \
            mock.patch.object(ops, "sa_stage_backward", ops.sa_stage_backward_plain), \
            mock.patch.object(ops, "furthest_point_sample_with_coords",
                              lambda xyz, npoint, impl="v1": ops.fps_plain(xyz, npoint)):
        yield


def plain_policy_path(model, pc, q, cdt, fast=0, bf16_cloud=False):
    """The kernel path's function from the kernels' plain versions (FPS,
    the SA stage) and ``fused.tail``, in row slices."""
    import torch

    from mpinets_torch.kernels import ops
    from mpinets_torch.model import fused

    w0, w1 = fused.sa_weights(model, cdt)
    radii = [size["radius"] for size in fused.stage_sizes(model)]

    def fwd(p, q_):
        x, f = p[..., :3].contiguous(), p[..., 3:].contiguous()
        if bf16_cloud:
            x = x.to(torch.bfloat16)
        _, c0 = ops.fps_plain(x, 512)
        chunks = ops.chunk_window(x, c0, fast) if fast else None
        f0_, _ = ops.sa_plain(x.float(), f, c0.float(), w0, radii[0], chunks)
        _, c1 = ops.fps_plain(c0, 128)
        f1_, _ = ops.sa_plain(c0.float(), f0_, c1.float(), w1, radii[1])
        return fused.tail(model, c1.float(), f1_, q_, cdt)
    with torch.no_grad():
        return by_rows(fwd, pc, q)


def sa_backward_row(mlp, xyz, feat, centroids, radius, n_points, smi, gen, launches=0):
    """The SA backward kernels (``ops.sa_stage_backward``) on one stage as the
    bf16 train step runs it: the v8 forward of the MLP ``mlp`` (six f32
    Dense tensors) on (xyz, feat, centroids), then the backward of a random
    cotangent, with the features' cotangent for ``n_points`` (SA1). Raised:
    per output, the relative L2 to the plain version within
    ``BF16_GRAD_FACTOR`` x the larger of the plain version's bf16-to-f32
    distance and the whole backward's, as the train gradients are held;
    dW and db bit-equal across two calls; and within ``SA_BWD_TOL`` under
    ``exact_mlp`` weights: one term an output on this cloud (each product
    sums one term), and ``SA_BWD_TERMS`` terms on a grid cloud of this
    shape (every sum of the forward exact in any order). Timed: the
    kernels, the plain version, the replay they replaced (autograd of
    ``fused_train._mlp_max`` over the raw block, the feature cotangent
    summed by index_add) and the bound: the forward, the input and the
    weight cotangents over the valid rows at the bf16 peak, or the valid raw
    rows, idx, g and gf once at the memory rate. -> the kernels-line entry."""
    import torch

    from mpinets_torch.kernels import ops
    from mpinets_torch.model.fused_train import _mlp_max

    bf16, dev = torch.bfloat16, xyz.device
    xyz, feat, centroids = (t.detach() for t in (xyz, feat, centroids))
    b, s = centroids.shape[:2]
    g = torch.randn((b, s, mlp[-1].shape[0]), generator=gen).to(dev)

    def prepared(tensors, cdt=bf16):
        return ops.prepare_sa_weights(*(t.to(dev) for t in tensors), compute_dtype=cdt)

    def backward(weights, x=xyz, f=feat, c=centroids):
        """The forward's raw block, then (kernel, plain) of its backward."""
        _, idx, raw = ops.sa_stage(x, f, c, weights, radius, impl="v8", centroids_in_cloud=True,
                                   return_raw=True)
        args = (raw, idx, c, weights, g, n_points)
        return args, ops.sa_stage_backward(*args), ops.sa_stage_backward_plain(*args)

    def worst(kernel, plain):
        return max(rel_l2(k, p) for k, p in zip(kernel, plain) if p is not None)

    w = prepared(mlp)
    args, kern, plain = backward(w)
    raw, idx = args[:2]
    plain32 = ops.sa_stage_backward_plain(raw, idx, centroids, prepared(mlp, torch.float32), g,
                                          n_points)
    pairs = [(k, p, p32) for k, p, p32 in zip(kern, plain, plain32) if p is not None]
    whole = rel_l2(torch.cat([p.flatten() for _, p, _ in pairs]),
                   torch.cat([p32.flatten() for _, _, p32 in pairs]))
    ratio = max(rel_l2(k, p) / (BF16_GRAD_FACTOR * max(rel_l2(p, p32), whole))
                for k, p, p32 in pairs)
    again = ops.sa_stage_backward(*args)
    same = all(torch.equal(a, b_) for a, b_ in zip(kern[1:], again[1:]))
    dims = (raw.shape[-1],) + tuple(t.shape[1] for t in mlp[::2])
    one = worst(*backward(prepared(exact_mlp(dims, gen)))[1:])
    xg, fg = (t.to(dev) for t in grid_cloud(*feat.shape[:2], feat.shape[2], gen))
    cg = ops.furthest_point_sample_with_coords(xg, s)[1]
    grid = worst(*backward(prepared(exact_mlp(dims, gen, SA_BWD_TERMS)), xg, fg, cg)[1:])

    valid = ops.valid_slots(idx)
    dense = [t.to(dev) for t in mlp]

    def replay():
        raw_ = raw.detach().requires_grad_(n_points is not None)
        tensors = [t.detach().requires_grad_() for t in dense]
        with torch.enable_grad():
            grads = torch.autograd.grad(_mlp_max(raw_, centroids, valid, *tensors, bf16),
                                        ([raw_] if n_points is not None else []) + tensors, g)
        if n_points is not None:
            c = raw.shape[-1] - 3
            delta = (grads[0][..., 3:] * valid[..., None]).to(bf16).float()
            at = idx.long() + n_points * torch.arange(b, device=dev)[:, None, None]
            torch.zeros((b * n_points, c), device=dev).index_add_(0, at.reshape(-1),
                                                                   delta.reshape(-1, c))

    kin, (c1, c2, c3) = dims[0], dims[1:]
    count = int(valid.sum())
    flops = 2.0 * count * (2 * (kin * c1 + c1 * c2 + c2 * c3) + c1 * c2 + c2 * c3
                           + (kin * c1 if n_points else 0))
    nbytes = 4 * (count * kin + idx.numel() + g.numel()
                  + (b * n_points * (kin - 3) if n_points else 0))
    bound_ms, bound_by = bound(nbytes, 0.0, flops)
    ms = cuda_ms(lambda: ops.sa_stage_backward(*args), 10)
    row = {"name": f"sa_bwd B={b} N={n_points or 0} S={s}", "route": "cuda",
           "source": CUDA_SOURCES["sa_bwd"], "replaces": TPU_SOURCES["sa_bwd"],
           "launches": launches,
           "max_abs_err": max((k - p).abs().max().item() for k, p, _ in pairs), "ms": ms,
           "plain_ms": cuda_ms(lambda: ops.sa_stage_backward_plain(*args), 2),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "replay_ms": cuda_ms(replay, 2), "valid_rows": count,
           "rel_l2": worst(kern, plain), "rel_l2_over_gate": ratio, "rel_l2_one_term": one,
           "rel_l2_grid": grid, "cpb": ops.sa_bwd_plan(b, s, *dims)["cpb"]}
    log(f"  {row['name']}: {launches} launches; {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {100 * bound_ms / ms:.1f}%), plain {row['plain_ms']:.3f} ms, replay "
        f"{row['replay_ms']:.3f} ms, {count} valid rows; worst rel L2 to plain "
        f"{row['rel_l2']:.2e} ({ratio:.3f} of its gate), dW bit-equal across calls {same}, "
        f"{one:.2e} (exact_mlp weights), {grid:.2e} ({SA_BWD_TERMS} terms, grid cloud) [{smi}]")
    if not (ratio <= 1.0 and same and one <= SA_BWD_TOL and grid <= SA_BWD_TOL):
        raise AssertionError(f"{row['name']}: kernel vs plain out of its gates: {row}, "
                             f"dW bit-equal {same}")
    return row


def sa_backward_rows(model, batch, smi, gen):
    """:func:`sa_backward_row` for SA0 and SA1 on a training batch, with the
    model's weights, as the bf16 train step runs them. -> the two rows."""
    from mpinets_torch.kernels import ops
    from mpinets_torch.model import fused
    from mpinets_torch.model.fused_train import _mlp_tensors

    enc = model.point_cloud_encoder
    xyz, feat = batch["xyz"][..., :3].contiguous(), batch["xyz"][..., 3:].contiguous()
    rows = []
    for stage, (size, npoint) in enumerate(zip(fused.stage_sizes(model), (512, 128))):
        mlp = [t.detach() for t in _mlp_tensors((enc.sa0, enc.sa1)[stage])]
        _, cent = ops.furthest_point_sample_with_coords(xyz, npoint)
        n = xyz.shape[1] if stage else None
        rows.append(sa_backward_row(mlp, xyz, feat, cent, size["radius"], n, smi, gen))
        feat = ops.sa_stage(xyz, feat, cent, ops.prepare_sa_weights(*mlp), size["radius"],
                            impl="v8", centroids_in_cloud=True)[0]  # SA1's features
        xyz = cent
    return rows


def sa_backward_at_shape(key, launches, cache, xyz, feat, sa_w, mlps, radii, smi, gen):
    """:func:`sa_backward_row` at a main path's launch key ("sa_bwd", B, N,
    S), N the features' points for SA1 and 0 for SA0, on the stage inputs
    of the cloud of that shape (``stage_inputs``). -> the kernels-line entry."""
    import torch

    _, b, n, s = key
    stage = 1 if n else 0
    cloud = next((c for c in CLOUDS if (c[1:] == (n, s) if n else c[1] == s)), None)
    if cloud is None:
        raise AssertionError(f"{key}: no stage of the clouds {CLOUDS} has this shape")
    xs, fs, cs, _ = stage_inputs(cache, b, cloud, xyz, feat, sa_w[torch.bfloat16], radii)[stage]
    return sa_backward_row(mlps[stage], xs, fs, cs, radii[stage], n or None, smi, gen, launches)


def step_times(step, min_s, chunk):
    """Seconds per call of ``step()``, one value per chunk of ``chunk``
    calls, over chunks until ``min_s`` seconds have passed (5 chunks at
    least); each chunk ends with a device synchronisation."""
    import torch

    times = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < min_s or len(times) < 5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / chunk)
    return times


def tabletop_scan(rng):
    """A numpy-made scan: a table top, its mount table and a few boxes."""
    import numpy as np

    parts = [
        np.stack([rng.uniform(0.3, 1.2, 12000), rng.uniform(-0.25, 0.9, 12000),
                  rng.normal(0.0, 0.002, 12000)], 1),
        np.stack([rng.uniform(-0.3, 0.25, 3000), rng.uniform(-0.45, 0.45, 3000),
                  rng.normal(0.0, 0.002, 3000)], 1),
    ]
    for _ in range(4):
        lo = np.array([rng.uniform(0.4, 0.9), rng.uniform(-0.2, 0.6), 0.0])
        size = rng.uniform(0.05, 0.2, 3)
        pts = lo + rng.uniform(0, 1, (2000, 3)) * size
        face = rng.integers(0, 3, 2000)
        pts[np.arange(2000), face] = (lo + size * rng.integers(0, 2, 2000)[:, None])[
            np.arange(2000), face]
        parts.append(pts)
    return np.concatenate(parts).astype(np.float32)


def tie_cloud(rng, b, n):
    """A [b, n, 3] f32 cloud on a 5^3 grid of step 0.5: most points share
    their position with others and many lie at equal distances, so FPS
    picks are decided by the lowest-index rule."""
    return (rng.integers(-2, 3, (b, n, 3)) * 0.5).astype("float32")


def sa_data_ops(idx, n, chunks, p, widths):
    """Operations this run's data needs for one SA call: f32 distance tests
    up to the 128th hit (or the whole candidate list), 9 uncontracted
    operations each, and the MLP over each centroid's max(count, 1) rows.
    -> (distance operations, MLP FLOP)."""
    import torch

    saturated = idx[..., 127] != idx[..., 0]
    kept = torch.where(saturated, 128, (idx != idx[..., :1]).sum(-1) + 1)
    if chunks is None:
        scanned = torch.where(saturated, idx[..., 127].long() + 1, n)
    else:
        last = idx[..., 127].long()
        rank = (chunks.long() == (last // 128)[..., None]).int().argmax(-1)
        scanned = torch.where(saturated, rank * 128 + last % 128 + 1, chunks.shape[-1] * 128)
    c1, c2, c3 = widths
    per_row = 2 * (p * c1 + c1 * c2 + c2 * c3)
    return 9.0 * float(scanned.sum()), float(kept.sum()) * per_row


def kernel_resources(log_text):
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: registers,
    spill stores and loads, stack frame bytes. -> {short name: dict}."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            t = re.search(r"([a-z][a-z_]*?_kernel(?:_mma)?)"
                          r"(?:I(?:Li(\d+)E)?Lb([01])ELb([01])ELb([01])E(?:Lb([01])E)?|ILi(\d+)E)?",
                          m.group(1))
            fps = re.search(r"fps_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E", m.group(1))
            roll = re.search(r"probe_roll_kernelILi(\d+)ELb([01])ELb([01])E", m.group(1))
            full = m.group(1)
            name = (f"fps_kernel<{'f32' if fps.group(1) == 'f' else 'bf16'}, {fps.group(2)}, "
                    f"cluster={fps.group(3)}>") if fps else (
                f"probe_roll_kernel<{roll.group(1)}, ragged={roll.group(2)}, "
                f"ring={roll.group(3)}>") if roll else full if t is None else t.group(1) + (
                f"<{f'tr={t.group(2)}, ' if t.group(2) else ''}raw={t.group(3)}, "
                f"point0={t.group(4)}, fast={t.group(5)}"
                f"{', wgmma=1' if t.group(6) == '1' else ''}>"
                if t.group(3) is not None
                else f"<{t.group(7)}>" if t.group(7) is not None
                else "<bf16>" if "bfloat16" in full else "<f32>" if "IfE" in full else "")
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_text(lib):
    """A built library's SASS (``cuobjdump -sass``), or None where the
    toolkit has no cuobjdump."""
    import shutil

    from mpinets_torch.kernels import ops

    tool = Path(ops._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if not tool:
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def sass_hmma(lib):
    """Tensor-core instructions per kernel in a built library's SASS, HMMA
    (mma.sync) and HGMMA (wgmma): {kernel: (HMMA, HGMMA)}, or None where the
    toolkit has no cuobjdump."""
    import re

    sass = sass_text(lib)
    if sass is None:
        return None
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += bool(re.search(r"\bHMMA\b", line))
            counts[name][1] += bool(re.search(r"\bHGMMA\b", line))
    return {k: tuple(v) for k, v in counts.items()}


def sass_loops(lib, pattern):
    """The loops of the kernel whose mangled name matches ``pattern`` in a
    built library's SASS: for each backward branch, the instructions from its
    target to it, and the FADD, FMUL, SHFL and f32/bf16 conversions (F2F,
    F2FP) among them. -> a list of {"instructions", "fadd", "fmul", "shfl",
    "f2f"}, or None where the toolkit has no cuobjdump."""
    import re

    sass = sass_text(lib)
    if sass is None:
        return None
    insts, labels, branches, inside, pending = [], {}, [], False, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if inside:
                break
            inside = re.search(pattern, m.group(1)) is not None
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for label in pending:
            labels[label] = addr
        pending = []
        insts.append((addr, text))
        b = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if b:
            branches.append((addr, b.group(1) or int(b.group(2), 16)))
    loops = []
    for addr, target in branches:
        target = labels.get(target, -1) if isinstance(target, str) else target
        if 0 <= target <= addr:
            body = [t for a, t in insts if target <= a <= addr]
            count = lambda op: sum(bool(re.search(op, t)) for t in body)
            loops.append({"instructions": len(body), "fadd": count(r"\bFADD\b"),
                          "fmul": count(r"\bFMUL\b"), "shfl": count(r"\bSHFL\b"),
                          "f2f": count(r"\bF2FP?\b")})
    return loops


def spread_cloud(gen, radius, c, b, dev, spread=SPREAD):
    """A cloud whose centroid i, at (i, 0, 0), has spread[i] points inside
    its ball (0.9 of the radius at most), shuffled among 400 points far from
    every ball; features uniform in [0, 1). -> (xyz, features, centroids)."""
    import torch

    cent = torch.tensor([(float(i), 0.0, 0.0) for i in range(len(spread))], device=dev)
    rows = []
    for _ in range(b):
        parts = [torch.rand(400, 3, generator=gen, device=dev) * 10 - 5
                 + torch.tensor([0.0, 0.0, 10.0], device=dev)]
        for centre, k in zip(cent, spread):
            d = torch.randn(k, 3, generator=gen, device=dev)
            r = 0.9 * radius * torch.rand(k, 1, generator=gen, device=dev) ** (1 / 3)
            parts.append(centre + d / d.norm(dim=1, keepdim=True) * r)
        pts = torch.cat(parts)
        rows.append(pts[torch.randperm(len(pts), generator=gen, device=dev)])
    xyz = torch.stack(rows).contiguous()
    feat = torch.rand(b, xyz.shape[1], c, generator=gen, device=dev)
    return xyz, feat, cent.expand(b, -1, -1).contiguous()


def bound(nbytes, dist_ops, mlp_flops=0.0, mlp_peak=BF16_FLOPS):
    """(ms, "bytes" | "operations"): bytes over the memory rate, or the
    distance tests' uncontracted f32 operations over the card's non-FMA f32
    rate plus the MLP's FLOP over ``mlp_peak``, whichever is longer."""
    from mpinets_torch.probes.session import F32_NOFMA_OPS, HBM_BYTES_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = dist_ops / F32_NOFMA_OPS + mlp_flops / mlp_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_GROUPS = (  # device-time buckets of a profile, by kernel name
    ("SA kernels", ("sa_kernel", "sa_select")),
    ("FPS kernel", ("fps_kernel",)),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
)


def kernel_rows(prof):
    """The profile's rows of device kernels, without the ranges annotated
    on the device timeline (``record_function``, ``Optimizer.step``)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_rollout(run, problem, generator, top=12):
    """Device time by kernel over one ``run(problem, generator)``, the same
    time in groups (``KERNEL_GROUPS``, the rest as "other"), and the
    device's busy share of the window: kernel time on the device over wall
    time. Only kernel rows count; the rows of the aten ops that launch them,
    and of the ranges annotated on the device timeline, repeat their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(problem, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key) for e in kernel_rows(prof)
            if e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        log("profiler: no device time recorded (CUDA events above are the timing)")
        return
    log(f"profiler: wall {wall * 1e3:.1f} ms, device kernel time {total / 1e3:.1f} ms, "
        f"busy share {total / 1e6 / wall:.3f}")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, copies, reductions)"] = 0.0
    for dev_us, _, key in rows:
        name = next((g for g, subs in KERNEL_GROUPS if any(x in key.lower() for x in subs)),
                    "other (elementwise, copies, reductions)")
        groups[name] += dev_us
    log("  by group: " + "; ".join(f"{g} {t / 1e3:.1f} ms ({100 * t / total:.1f}%)"
                                   for g, t in groups.items()))
    for dev_us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / total:5.1f}%  x{count:<5d} {key[:90]}")


def profile_train_layers(state, apply, make_batch, steps=3):
    """Device and host milliseconds per step in each layer of the trainer's
    step (``learner.make_train_step`` with the batch generation before it),
    over ``steps`` profiled steps. A layer is a ``record_function`` range;
    its device time counts the kernels launched under it. The backward runs
    on autograd's own thread, so it is read from autograd's per-node
    ranges: the SA stages' (``SAStageTrainBackward``, plain torch) apart
    from the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpinets_torch.train import learner

    def forward(model, xyz, q):
        with record_function("train: policy forward"):
            return apply(model, xyz, q)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("train: batch generation"):
                batch = make_batch()
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("train: policy forward + loss"):
                total, _ = learner.loss_fn(state.model, batch, apply_fn=forward)
            with record_function("train: backward (host call)"):
                total.backward()
            with record_function("train: optimizer"):
                state.optimizer.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    kernels = sum(e.self_device_time_total for e in kernel_rows(prof))

    def kernel_us(e):
        """Device time of the kernels launched under a CPU event, its
        children's included. A range's mirror on the device timeline (a
        user annotation, under the range's own name) is not a kernel."""
        return (sum(k.duration for k in e.kernels if k.name != e.name)
                + sum(kernel_us(c) for c in e.cpu_children))

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e

    def ms(pred, host=False):
        us = sum(e.cpu_time_total if host else kernel_us(e) for e in events if pred(e))
        return us / 1e3 / steps

    # autograd's per-node ranges; a node's own torch.autograd.grad nests more
    node = "autograd::engine::evaluate_function: "
    is_bwd = lambda e: e.name.startswith(node) and not any(
        a.name.startswith(node) for a in ancestors(e))
    is_sa_bwd = lambda e: e.name == node + "SAStageTrainBackward" and is_bwd(e)
    named = lambda label: lambda e: e.name == label
    fwd, fwd_loss = named("train: policy forward"), named("train: policy forward + loss")
    layers = [
        ("batch generation", ms(named("train: batch generation")),
         ms(named("train: batch generation"), True)),
        ("policy forward (FPS, SA kernels, tail)", ms(fwd), ms(fwd, True)),
        ("loss (loss-bank FK, SDF)", ms(fwd_loss) - ms(fwd), ms(fwd_loss, True) - ms(fwd, True)),
        ("backward: SA stages (plain torch)", ms(is_sa_bwd), ms(is_sa_bwd, True)),
        ("backward: the rest", ms(is_bwd) - ms(is_sa_bwd), ms(is_bwd, True) - ms(is_sa_bwd, True)),
        ("optimizer (clip + Adam)", ms(named("train: optimizer")),
         ms(named("train: optimizer"), True)),
    ]
    log(f"train layers over {steps} steps: wall {1e3 * wall / steps:.2f} ms/step, device "
        f"kernel time {kernels / 1e3 / steps:.2f} ms/step (busy share "
        f"{kernels / 1e6 / wall:.3f}), the layers' sum {sum(d for _, d, _ in layers):.2f} "
        f"ms/step; backward host call {ms(named('train: backward (host call)'), True):.2f} "
        f"ms/step")
    for name, dev_ms, host_ms in layers:
        log(f"  {name:40s} device {dev_ms:8.3f} ms/step  host {host_ms:8.3f} ms/step")


# The clouds the main paths run: (points, SA0 centroids, SA1 centroids) at
# the reference widths, and the small trainer's cloud.
CLOUDS = ((6272, 512, 128), (64 + 96 + 32, 16, 8))


def stage_inputs(cache, b, cloud, xyz, feat, weights, radii):
    """The kernel path's SA0 and SA1 inputs for the first ``b`` rows and
    ``cloud[0]`` points of the assembled cloud: ((xyz, feat, centroids,
    selection) per stage), made once per (b, cloud) and kept in ``cache``."""
    from mpinets_torch.kernels import ops

    if (b, cloud) not in cache:
        n0, s0, s1 = cloud
        x0, f0 = xyz[:b, :n0].contiguous(), feat[:b, :n0].contiguous()
        c0 = ops.furthest_point_sample_with_coords(x0, s0)[1]
        sel0 = ops.sa_select(x0, c0, radii[0])
        h0 = ops.sa_kernel(x0, f0, c0, weights[0], radii[0], selection=sel0)[0]
        c1 = ops.furthest_point_sample_with_coords(c0, s1)[1]
        cache[b, cloud] = ((x0, f0, c0, sel0), (c0, h0, c1, ops.sa_select(c0, c1, radii[1])))
    return cache[b, cloud]


def time_at_shape(key, launches, cache, xyz, feat, sa_w, radii, smi):
    """Kernel ``key[0]`` at batch, cloud and centroids ``key[1:]``: against
    its plain version (FPS and ball-query indices equal, MLP features
    within BF16_TOL, or F32_TOL for an ``_f32`` kernel, x max(1, max|f|)),
    timed with its plain version, and its bound from this input's data.
    The SA MLP kernels (sa, sa_raw, sa_v3) read the ball query's
    selection, as on the exact path; sa_fast scans its window. An SA
    kernel runs with the weights of its type (``sa_w`` by dtype): bf16 on
    the tensor cores, ``_f32`` on the CUDA cores, whose MLP bound takes the
    f32 peak. -> the kernels-line entry."""
    import torch

    from mpinets_torch.kernels import ops
    from mpinets_torch.probes.session import F32_FLOPS

    name, b, n, s = key
    is_f32 = name.endswith("_f32")
    k = name.removesuffix("_f32")
    weights = sa_w[torch.float32 if is_f32 else torch.bfloat16]
    cloud, stage = next(((c, st) for c in CLOUDS for st, shape in enumerate((c[:2], c[1:]))
                         if shape == (n, s)), (None, None))
    if cloud is None:
        raise AssertionError(f"{key}: no stage of the clouds {CLOUDS} has this shape")
    xs, fs, cs, sel = stage_inputs(cache, b, cloud, xyz, feat, sa_w[torch.bfloat16],
                                   radii)[stage]
    w, radius = weights[stage], radii[stage]
    c1, c2, c3 = w.w1.shape[1], w.w2.shape[1], w.w3.shape[1]
    per_row = 2.0 * ((3 + fs.shape[-1]) * c1 + c1 * c2 + c2 * c3)
    w_bytes = 4 * sum(t.numel() for t in w.tensors)
    mlp_ops = f32_ops = 0.0
    err = 0.0
    if k == "fps":
        run = lambda: ops.furthest_point_sample_with_coords(xs, s)
        plain = lambda: by_rows(lambda t: ops.fps_plain(t, s), xs)
        out, ref = run(), plain()
        same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        nbytes, f32_ops = b * n * 12 + b * s * 16, 9.0 * (s - 1) * n * b
    elif k == "sa_select":
        run = lambda: ops.sa_select(xs, cs, radius)
        plain = lambda: by_rows(lambda x_, c_: ops.sa_select_plain(x_, c_, radius), xs, cs)
        out, ref = run(), plain()
        same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        idx, count = out
        scanned = torch.where(count == 128, idx[..., 127].long() + 1, n)   # to the 128th hit
        nbytes = 4 * (xs.numel() + cs.numel() + idx.numel() + count.numel())
        f32_ops = 9.0 * float(scanned.sum())
    else:
        if k == "sa_fast":
            chunks = ops.chunk_window(xs, cs, FAST_W)
            run = lambda: ops.sa_kernel(xs, fs, cs, w, radius, chunks)
            plain = lambda: by_rows(lambda x_, f_, c_, ch_: ops.sa_plain(x_, f_, c_, w, radius, ch_),
                                    xs, fs, cs, chunks)
            out, ref = run(), plain()
            same = torch.equal(out[1], ref[1])
            f32_ops, mlp_ops = sa_data_ops(out[1], n, chunks, 3 + fs.shape[-1], (c1, c2, c3))
            nbytes = 4 * (xs.numel() + fs.numel() + cs.numel() + chunks.numel()
                          + b * s * (c3 + 128)) + w_bytes
        else:   # the MLP kernel alone, reading the selection
            in_cloud, raw = k != "sa_v3", k == "sa_raw"
            run = lambda: ops.sa_kernel(xs, fs, cs, w, radius, None, in_cloud, raw, selection=sel)
            plain = lambda: by_rows(
                lambda x_, f_, c_, i_, n_: ops.sa_mlp_plain(x_, f_, c_, w, i_, n_, in_cloud, raw),
                xs, fs, cs, *sel)
            out, ref = run(), plain()
            if raw:
                same, out, ref = torch.equal(out[2], ref[1]), out, (ref[0],)
            else:
                same, ref = True, (ref,)
            mlp_ops = float(sel[1].clamp(min=1).sum()) * per_row
            nbytes = 4 * (xs.numel() + fs.numel() + cs.numel() + sel[0].numel() + sel[1].numel()
                          + b * s * c3 + (b * s * 128 * (3 + fs.shape[-1]) if raw else 0)) + w_bytes
        err = (out[0] - ref[0]).abs().max().item()
        tol = (F32_TOL if is_f32 else BF16_TOL) * max(1.0, ref[0].abs().max().item())
        if not err <= tol:
            raise AssertionError(f"{key}: feature error {err} > {tol}")
    torch.cuda.synchronize()
    if not same:
        raise AssertionError(f"{key}: indices (or the raw block) differ from the plain version")
    ms = cuda_ms(run, 5)
    plain_ms = cuda_ms(plain, 1)
    bnd, by = bound(nbytes, f32_ops, mlp_ops, F32_FLOPS if is_f32 else BF16_FLOPS)
    extra = {}
    if k == "fps":
        extra = {"plan": list(ops.fps_plan(b, n)), "ns_per_pick": ms * 1e6 / max(s - 1, 1)}
    elif k != "sa_select":
        extra = {"cpb": ops.sa_launch_plan(w, fs.shape[-1], b, s, k != "sa_v3", k == "sa_raw",
                                           k == "sa_fast")["cpb"]}
    log(f"{name} B={b} N={n} S={s}: {launches} launches; kernel {ms:.4f} ms, plain {plain_ms:.3f}"
        f" ms, bound {bnd:.4f} ms ({by}), max |err| {err:.3e}"
        + "".join(f", {key} {val}" for key, val in extra.items()) + f" [{smi}]")
    return {"name": f"{name} B={b} N={n} S={s}", "route": "cuda", "source": CUDA_SOURCES[k],
            "replaces": TPU_SOURCES[k], "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": None, **extra}


# The evaluation phase: cli.infer's runs (label, flags, kernels each must
# launch, problems a group), and the reference Evaluator's metric keys
# (mpinets_tpu/eval/metrics.py:565-663).
EVAL_GROUP = 32
EVAL_RUNS = (
    ("bf16, exact", ["--batch-size", "32"], ("fps", "sa_select", "sa"), 32),
    ("--fp32", ["--fp32", "--max-problems", "32"], ("fps", "sa_select", "sa_f32"), 32),
    ("--fast-grouping 4", ["--fast-grouping", "4", "--max-problems", "32"],
     ("fps", "sa_select", "sa", "sa_fast"), 32),
    ("--use-depth", ["--use-depth", "--max-problems", "16"], ("fps", "sa_select", "sa"), 16),
    ("--b1-timing", ["--b1-timing", "--max-problems", "8"], ("fps", "sa_select", "sa"), 8),
)
METRIC_KEYS = {
    "success", "total", "skips", "time", "step time", "env collision", "self collision",
    "joint violation", "physical violations", "average collision depth",
    "median collision depth", "1 cm", "5 cm", "15 deg", "30 deg", "165 deg", "is smooth",
    "average config sparc", "average eff sparc", "eff position path length",
    "eff orientation path length",
}
CHECK_TOL = 1e-4          # check_trajectories, card vs CPU: floats within 1e-4 x max(1, |x|)
CHECK_ORI_TOL_DEG = 0.05  # ... orientation errors (arccos near 0) within 0.05 deg, and the
                          # orientation path within 0.05 deg a live segment
DEPTH_SURFACE_TOL = 5e-3  # a sensed point's distance to a primitive's surface, m


def eval_problem_set(rng, n=EVAL_GROUP):
    """Two groups of ``n`` problems from a numpy seed, as port types:
    tabletop/task-oriented and cubby/neutral-start. Each has a table and
    2-4 boxes on it, ``q0`` inside the joint limits, a target at the FK pose
    of a configuration near ``q0`` and a target cuboid around it; each cubby
    problem has a negative volume beside its target."""
    import numpy as np
    import torch

    from mpinets_torch import types as T
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.robot import franka

    lo, hi = franka.JOINT_LIMITS[:, 0], franka.JOINT_LIMITS[:, 1]
    pad = 0.05 * (hi - lo)
    groups = {}
    for scene_type, problem_type in (("tabletop", "task-oriented"), ("cubby", "neutral-start")):
        probs = []
        for _ in range(n):
            q0 = rng.uniform(lo + pad, hi - pad)
            near = np.clip(q0 + rng.uniform(-0.3, 0.3, 7), lo + pad, hi - pad)
            pos, quat = (t.double().numpy() for t in kinematics.eff_pose_quat(
                torch.from_numpy(near.astype(np.float32))))
            obstacles = [T.Cuboid([0.6, 0.0, -0.02], [1.0, 1.6, 0.04], [1, 0, 0, 0])]
            for _ in range(int(rng.integers(2, 5))):
                dims = rng.uniform(0.05, 0.2, 3)
                centre = [rng.uniform(0.4, 0.9), rng.uniform(-0.6, 0.6), dims[2] / 2]
                obstacles.append(T.Cuboid(centre, dims, [1, 0, 0, 0]))
            negatives = ([T.Cuboid(pos + [0.0, 0.0, 0.25], [0.1, 0.1, 0.1], [1, 0, 0, 0])]
                         if scene_type == "cubby" else [])
            probs.append(T.PlanningProblem(
                target=T.Pose(pos, quat),
                target_volume=T.Cuboid(pos, [0.3, 0.3, 0.3], [1, 0, 0, 0]),
                q0=q0, obstacles=obstacles, target_negative_volumes=negatives))
        groups[scene_type] = {problem_type: probs}
    return groups


def check_card_against_cpu(args):
    """``check_trajectories`` on the card against the same function on the
    CPU, on the same batch: booleans equal, floats within CHECK_TOL x
    max(1, |x|), orientation errors within CHECK_ORI_TOL_DEG and the
    orientation path length within CHECK_ORI_TOL_DEG a live segment (a
    sum of arccos values near 0, each about 0.02 deg from one f32 ulp of
    its trace). -> (worst float error over its tolerance, its key)."""
    import numpy as np
    import torch

    from mpinets_torch.eval.metrics import check_trajectories, to_host

    traj, num_steps, rot, trans, scene, tv, neg = args
    cuda = to_host(check_trajectories(traj.cuda(), torch.as_tensor(num_steps).cuda(),
                                      rot.cuda(), trans.cuda(), scene.to("cuda"),
                                      tv.to("cuda"), neg.to("cuda")))
    cpu = to_host(check_trajectories(traj.cpu(), torch.as_tensor(num_steps), rot.cpu(),
                                     trans.cpu(), scene.to("cpu"), tv.to("cpu"),
                                     neg.to("cpu")))
    worst = (0.0, None)
    segments = np.maximum(np.asarray(num_steps), 1)
    for key, ref in cpu.items():
        if ref.dtype == bool:
            if not np.array_equal(cuda[key], ref):
                raise AssertionError(f"check_trajectories {key}: card and CPU differ at "
                                     f"{int((cuda[key] != ref).sum())} entries")
            continue
        err = np.abs(cuda[key] - ref)
        tol = (CHECK_ORI_TOL_DEG if key == "orientation_error"
               else CHECK_ORI_TOL_DEG * segments if key == "eff_orientation_path_length"
               else CHECK_TOL * np.maximum(1.0, np.abs(ref)))
        worst = max(worst, (float((err / tol).max()), key))
        if not (err <= tol).all():
            raise AssertionError(f"check_trajectories {key}: card vs CPU error {err.max()}")
    return worst


def run_evaluation(model, smi, count_path):
    """The evaluation path a user runs (``python -m mpinets_torch.cli.infer``)
    at full widths, from a problem-set pickle and a ``.npz`` of the random
    policy, in each mode of EVAL_RUNS, with its gates. -> per-run summary."""
    import pickle

    import numpy as np
    import torch

    from mpinets_torch.cli import infer
    from mpinets_torch.data import problems as P
    from mpinets_torch.eval import metrics
    from mpinets_torch.geom import depth
    from mpinets_torch.kernels import ops
    from mpinets_torch.kernels.sdf import scene_sdf
    from mpinets_torch.model import checkpoint as ckpt
    from mpinets_torch.model.fused import make_fused_apply
    from mpinets_torch.rollout.engine import make_rollout_fn

    summary = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        pset = eval_problem_set(np.random.default_rng(SEED + 7))
        P.save_problems(tmp / "problems.pkl", pset)
        loaded = P.load_problems(tmp / "problems.pkl")
        for scene_type, by_type in pset.items():
            for problem_type, probs in by_type.items():
                back = loaded[scene_type][problem_type]
                if len(back) != len(probs) or any(
                        not np.array_equal(a.q0, b.q0) or len(a.obstacles) != len(b.obstacles)
                        for a, b in zip(back, probs)):
                    raise AssertionError("the problem set did not read back as written")
        ckpt.save_flax_npz(tmp / "policy.npz", ckpt.flax_from_params(model.state_dict()))
        for label, flags, kernels, per_group in EVAL_RUNS:
            out_dir = tmp / f"metrics_{len(summary)}"
            batches, sensed, eval_s = [], [], [0.0]
            real_eval, real_cloud = metrics.Evaluator.evaluate_batch, depth.scene_to_point_cloud

            def spy_eval(self, *args, **kw):
                batches.append(args[:7])
                t_eval = time.perf_counter()
                real_eval(self, *args, **kw)    # ends with the checks' copy to the host
                eval_s[0] += time.perf_counter() - t_eval

            def spy_cloud(scene, *args, **kw):
                sensed.append((scene, real_cloud(scene, *args, **kw)))
                return sensed[-1][1]

            printed = io.StringIO()
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(metrics.Evaluator, "evaluate_batch", spy_eval), \
                    mock.patch.object(depth, "scene_to_point_cloud", spy_cloud), \
                    contextlib.redirect_stdout(printed):
                ev = infer.main([str(tmp / "policy.npz"), str(tmp / "problems.pkl"), "all",
                                 "all", "--save-metrics", str(out_dir), *flags])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            count_path(f"evaluation {label}", kernels)
            # --- gates -----------------------------------------------------
            if set(ev.groups) != {"tabletop_task-oriented", "cubby_neutral-start"}:
                raise AssertionError(f"evaluation {label}: groups {sorted(ev.groups)}")
            with open(out_dir / "mpinets_torch_eval_metrics.pkl", "rb") as f:
                saved = pickle.load(f)
            if saved.keys() != ev.groups.keys():
                raise AssertionError(f"evaluation {label}: the saved pickle's groups differ")
            rows = {}
            for key, group in saved.items():
                m = ev.metrics(group)
                if set(m) != METRIC_KEYS or m["total"] != per_group:
                    raise AssertionError(f"evaluation {label} {key}: keys {sorted(m)}, total "
                                         f"{m['total']} (expected {per_group})")
                fresh = ev.metrics(ev.groups[key])
                if not all(np.allclose(np.asarray(m[k], float), np.asarray(fresh[k], float),
                                       equal_nan=True) for k in m):
                    raise AssertionError(f"evaluation {label} {key}: the pickle's metrics differ")
                rows[key] = {k: float(m[k]) for k in ("success", "env collision", "1 cm",
                                                      "average config sparc")}
            worst, worst_key = check_card_against_cpu(batches[0])
            extra = ""
            if "--use-depth" in flags:
                if len(sensed) != 2:
                    raise AssertionError(f"evaluation {label}: {len(sensed)} depth renders")
                far = max(float(scene_sdf(cloud, scene).abs().max()) for scene, cloud in sensed)
                if not far <= DEPTH_SURFACE_TOL:
                    raise AssertionError(f"evaluation {label}: a sensed point lies {far} m "
                                         "from every surface")
                extra = f"; sensed points at most {far:.2e} m from a surface"
            notes = [line for line in printed.getvalue().splitlines()
                     if line.startswith(("# rollout path", "# batch-1"))]
            n = sum(m_["total"] for m_ in map(ev.metrics, ev.groups.values()))
            summary[label] = {"seconds": seconds, "problems": n, "problems_per_s": n / seconds,
                              "evaluator_seconds": eval_s[0], "groups": rows}
            log(f"evaluation {label}: {n} problems in {seconds:.2f} s ({n / seconds:.2f} "
                f"problems/s, 150 steps each unless solved; the Evaluator's checks and SPARC "
                f"{eval_s[0]:.2f} s of it); {'; '.join(notes)}; by group "
                f"{rows}; check_trajectories card vs CPU: booleans equal, worst float error "
                f"{worst:.3f} of its tolerance ({worst_key}){extra} [{smi}]")

        phase(f"profile: one 5-step evaluation rollout, B={EVAL_GROUP}, exact, bf16 "
              "(torch.profiler)")
        batch = P.problems_to_batch(pset["tabletop"]["task-oriented"], device="cuda")
        rollout = make_rollout_fn(model, max_steps=5, device="cuda",
                                  apply_fn=make_fused_apply(torch.bfloat16))
        profile_rollout(rollout, batch["problem"], torch.Generator("cuda").manual_seed(SEED))
    return summary


# ---- scene generation: batched IK and the procedural environments ---------
SCENES_PER_ENV = 4        # scenes per environment, from numpy seed 0
IK_SEEDS = 16             # seeds per target, as the environments solve
IK_EDGE = 1e-5            # flags are compared, and candidates re-checked, this far from the
                          # IK tolerances (the f32 arccos at ORI_TOL)
IK_FLAG_SHARE = 0.97      # end to end, card flags equal to the CPU's on this share of the
                          # targets: 30 DLS steps from random seeds round apart (see below)
IK_SCORE_TIE = 1e-4       # a pick ties the best seed within this much of pos + 0.1 ori
IK_STEP_F64_TOL = 1e-8    # residual, Jacobian and one DLS step, card vs CPU, in f64
IK_TIMED = (320, 4096)    # targets of the timed IK calls (x IK_SEEDS DLS solves)


def near_tolerance(pos, ori):
    from mpinets_torch.kernels import ik

    return ((pos - ik.POS_TOL).abs() < IK_EDGE) | ((ori - ik.ORI_TOL).abs() < IK_EDGE)


def recheck_candidates(cands, scene_cpu, free_margin=None):
    """Re-check candidates made on the card, on the CPU: each configuration
    reaches its pose within the IK tolerances (+ IK_EDGE) and, where a
    margin is given, clears the scene and itself by it (- IK_EDGE)."""
    import numpy as np
    import torch

    from mpinets_torch.kernels import ik

    if not cands:
        return
    q = torch.as_tensor(np.stack([c.config for c in cands]), dtype=torch.float32)
    rot = torch.as_tensor(np.stack([c.pose.matrix[:3, :3] for c in cands]), dtype=torch.float32)
    trans = torch.as_tensor(np.stack([c.pose.position for c in cands]), dtype=torch.float32)
    pos, ori = ik.pose_errors(q, rot, trans)
    if not (bool((pos < ik.POS_TOL + IK_EDGE).all()) and bool((ori < ik.ORI_TOL + IK_EDGE).all())):
        raise AssertionError(f"a candidate misses its pose on the CPU: {pos.max()}, {ori.max()}")
    if free_margin is not None and not bool(
            ik.franka_free_space(q, scene_cpu, free_margin - IK_EDGE).all()):
        raise AssertionError("a candidate collides on the CPU")


def run_scene_generation(smi):
    """Scene and candidate generation on the card (``mpinets_torch.envs``
    through ``kernels.ik``): the IK card against the CPU on one batch of 320
    tabletop poses with the same draws; IK throughput, each call also
    captured in a CUDA graph (no host sync) and its replay timed; then
    SCENES_PER_ENV scenes of each environment with the CPU re-check of every
    candidate. -> summary."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpinets_torch import envs
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.kernels import ik

    dev = torch.device("cuda")
    summary = {}

    # -- the IK, card against CPU, on one batch of scene-sampled poses --------
    rng = np.random.default_rng(SEED)
    env = envs.TabletopEnvironment(device=dev)
    while not env.gen(rng):
        pass
    scene, scene_cpu = env._unbatched_scene(), SceneSet(*(t.cpu() for t in env._unbatched_scene()))
    poses = env.sample_candidate_poses(rng, max(IK_TIMED))
    rot_all = torch.as_tensor(np.stack([p.matrix[:3, :3] for p in poses]), dtype=torch.float32)
    trans_all = torch.as_tensor(np.stack([p.position for p in poses]), dtype=torch.float32)
    rot, trans = rot_all[:IK_TIMED[0]], trans_all[:IK_TIMED[0]]
    b = rot.shape[0]
    key = int(rng.integers(0, 2**31 - 1))
    u = ik.draw_uniforms(key, IK_SEEDS, b)
    seeds = ik.seeds_from_draws(u)
    if not torch.equal(ik.seeds_from_draws(ik.draw_uniforms(key, IK_SEEDS, b, dev)).cpu(), seeds):
        raise AssertionError("IK: the seeds on the card differ from the CPU's")

    # the formulas in f64: residual, Jacobian and one DLS step from the seeds,
    # the [S, B] pairs flat
    flat = (seeds.double().reshape(-1, 7),
            rot.double().expand(IK_SEEDS, b, 3, 3).reshape(-1, 3, 3),
            trans.double().expand(IK_SEEDS, b, 3).reshape(-1, 3))
    e_c, j_c = ik.residual_and_jacobian(*flat)
    e_g, j_g = ik.residual_and_jacobian(*(t.to(dev) for t in flat))
    step_c, step_g = ik.dls_step(*flat), ik.dls_step(*(t.to(dev) for t in flat))
    f64_err = max(float((e_g.cpu() - e_c).abs().max()), float((j_g.cpu() - j_c).abs().max()),
                  float((step_g.cpu() - step_c).abs().max()))
    log(f"IK, card vs CPU in f64 on {IK_SEEDS} x {b} seeds: residual, Jacobian and one DLS "
        f"step within {f64_err:.3g} (gate {IK_STEP_F64_TOL})")
    if not f64_err <= IK_STEP_F64_TOL:
        raise AssertionError(f"IK: card and CPU differ by {f64_err} in f64")

    # acceptance and selection on the same per-seed solutions (the CPU's)
    qs = ik.dls_solve(seeds, rot, trans)
    pos, ori = ik.pose_errors(qs, rot, trans)
    ok_s = (pos < ik.POS_TOL) & (ori < ik.ORI_TOL) & ik.franka_free_space(qs, scene_cpu)
    score = pos + 0.1 * ori + torch.where(ok_s, 0.0, 1e6)   # collision_free_ik's ranking
    best = score.argmin(0)
    cols = torch.arange(b)
    with mock.patch.object(ik, "dls_solve", lambda *a, **k: qs.to(dev)):
        got = [t.cpu() for t in ik.collision_free_ik(None, rot.to(dev), trans.to(dev), scene,
                                                     draws=u.to(dev))]
    pick = (qs == got[0][None]).all(-1).float().argmax(0)
    if not bool((qs[pick, cols] == got[0]).all()):
        raise AssertionError("IK: a card pick is none of the seeds' solutions")
    pos_b, ori_b = ik.pose_errors(qs[best, cols], rot, trans)
    away = ~near_tolerance(pos_b, ori_b) & ~near_tolerance(got[2], got[3])
    low = score[best, cols]
    tie = low + IK_SCORE_TIE + torch.where(low >= 1e6, 0.0625, 0.0)
    if not (torch.equal(got[1][away], ok_s[best, cols][away]) and bool((score[pick, cols] <= tie).all())):
        raise AssertionError("IK: acceptance or selection on the card differs from the CPU's")
    log(f"IK acceptance and selection on the CPU's per-seed solutions: flags equal on "
        f"{int(away.sum())} of {b} targets away from the tolerances; every pick within "
        f"{IK_SCORE_TIE} of the best seed's score; the same seed picked for "
        f"{int((pick == best).sum())}")

    # end to end, card against CPU, on the same integer seed
    got = [t.cpu() for t in ik.collision_free_ik(key, rot.to(dev), trans.to(dev), scene)]
    ref = ik.collision_free_ik(key, rot, trans, scene_cpu)
    away = ~near_tolerance(ref.pos_err, ref.ori_err) & ~near_tolerance(got[2], got[3])
    share = float((got[1] == ref.converged)[away].float().mean())
    both = got[1] & ref.converged
    same_q = int(((got[0] - ref.q).abs().amax(-1) <= 1e-4)[both].sum())
    log(f"IK end to end, card vs CPU, {b} targets x {IK_SEEDS} seeds: ok {int(got[1].sum())} / "
        f"{int(ref.converged.sum())}, flags equal on {share:.4f} of the targets away from the "
        f"tolerances (gate {IK_FLAG_SHARE}); q within 1e-4 on {same_q} of the {int(both.sum())} "
        f"targets both accept (the others picked another seed, or a seed rounded onto another "
        f"solution)")
    if share < IK_FLAG_SHARE:
        raise AssertionError(f"IK: card and CPU flags agree on {share} of the targets")
    pos, ori = ik.pose_errors(got[0], rot, trans)
    if not (bool((pos[got[1]] < ik.POS_TOL + IK_EDGE).all())
            and bool((ori[got[1]] < ik.ORI_TOL + IK_EDGE).all())
            and bool(ik.franka_free_space(got[0][got[1]], scene_cpu, -IK_EDGE).all())):
        raise AssertionError("IK: a solution the card accepts fails on the CPU")
    summary["card_vs_cpu"] = {"targets": b, "ok_card": int(got[1].sum()),
                              "ok_cpu": int(ref.converged.sum()), "flags_equal_share": share,
                              "q_within_1e-4": same_q, "both_ok": int(both.sum()),
                              "f64_step_err": f64_err}

    # -- throughput, and no host sync inside a call ----------------------------
    # A call captures into a CUDA graph: a host sync while capturing raises.
    # (Queued behind a busy card, a call still blocks the host once its
    # thousands of launches fill the launch queue, so "returned while the
    # card was busy" is no test of it.) The graph's replay times the same
    # call without the host's launches.
    rates = {}
    for n in IK_TIMED:
        args = (rot_all[:n].to(dev), trans_all[:n].to(dev), scene)
        times = []
        for rep in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ik.collision_free_ik(key + rep, *args)
            res.converged.cpu()
            times.append(time.perf_counter() - t0)
        t = float(np.median(times[1:]))
        draws = ik.draw_uniforms(key, IK_SEEDS, n, dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # the warm-up capture asks for, off the default stream
            eager = ik.collision_free_ik(None, *args, draws=draws)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ik.collision_free_ik(None, *args, draws=draws)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(eager, captured)):
            raise AssertionError(f"collision_free_ik ({n}): the graph's replay differs")
        replay = cuda_ms(graph.replay, 3)
        del graph, captured
        rates[n] = {"s": t, "targets_per_s": n / t, "dls_solves_per_s": n * IK_SEEDS / t,
                    "times_s": times[1:], "graph_replay_ms": replay}
        log(f"collision_free_ik, {n} targets x {IK_SEEDS} seeds, 30 DLS steps: median "
            f"{t * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in times[1:])}), "
            f"{n / t:.1f} targets/s, {n * IK_SEEDS / t:.1f} DLS solves/s; captured in a CUDA "
            f"graph (no host sync), its replay {replay:.2f} ms, equal to the call [{smi}]")
    summary["ik"] = rates

    # -- the four environments ---------------------------------------------
    for name, cls in envs.ENVIRONMENTS.items():
        rng = np.random.default_rng(SEED)
        stats = {"scenes": 0, "kept": 0, "gen_s": 0.0, "candidates_s": 0.0}
        for _ in range(SCENES_PER_ENV):
            env = cls(device=dev)
            t0 = time.perf_counter()
            kept = env.gen(rng)
            stats["gen_s"] += time.perf_counter() - t0
            stats["scenes"] += 1
            if not kept:
                continue
            stats["kept"] += 1
            if len(env.demo_candidates) != 2:
                raise AssertionError(f"{name}: {len(env.demo_candidates)} demo candidates")
            before = dict(env.funnel)
            t0 = time.perf_counter()
            extra = env.gen_candidates(rng, 10)
            neutral = env.gen_neutral_candidates(5, rng)
            stats["candidates_s"] += time.perf_counter() - t0
            f = env.funnel
            delta = {k: f[k] - before[k] for k in f}
            if not (delta["poses"] == 320 and delta["kept"] == len(extra) <= 10
                    and delta["ik_solved"] >= delta["free"] >= delta["kept"]
                    and f["poses"] >= f["ik_solved"] >= f["free"] >= f["kept"] >= 2 + len(extra)):
                raise AssertionError(f"{name}: the funnel does not add up: {f}, {delta}")
            scene_cpu = SceneSet(*(t.cpu() for t in env._unbatched_scene()))
            # demo candidates were solved in the scene as it stood then (a
            # dresser's start before its target drawer opened): reach only
            recheck_candidates(env.demo_candidates, scene_cpu)
            recheck_candidates(extra, scene_cpu, 0.0)
            recheck_candidates(neutral, scene_cpu, 0.01)
            stats.setdefault("funnel", []).append(dict(f))
            stats.setdefault("candidates", []).append([len(extra), len(neutral)])
        if not stats["kept"]:
            raise AssertionError(f"{name}: no scene kept of {SCENES_PER_ENV}")
        stats["scenes_per_s"] = stats["kept"] / stats["gen_s"]
        log(f"{name}: {stats['kept']} of {stats['scenes']} scenes kept in {stats['gen_s']:.3f} s "
            f"of gen ({stats['scenes_per_s']:.2f} kept scenes/s, "
            f"{stats['scenes'] / stats['gen_s']:.2f} attempts/s); gen_candidates(10) + "
            f"gen_neutral_candidates(5) {stats['candidates_s']:.3f} s in all; [extra, neutral] "
            f"{stats['candidates']}; funnels {stats['funnel']} [{smi}]")
        summary[name] = stats

    # -- the device's busy share of one gen_candidates call ------------------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env.gen_candidates(rng, 10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in kernel_rows(prof))
    summary["gen_candidates_busy_share"] = busy_us / 1e6 / wall
    log(f"profile of one gen_candidates(10) ({type(env).__name__}, 320 poses x {IK_SEEDS} "
        f"seeds): wall {wall * 1e3:.1f} ms, device kernel time {busy_us / 1e3:.1f} ms, busy "
        f"share {busy_us / 1e6 / wall:.3f} [{smi}]")
    return summary


# ---- the expert pipeline and the DAgger actors ------------------------------
PLAN_CANDIDATES = 4       # gen's default candidates_per_scene
PLAN_CHECK_PAIRS = 8      # card against CPU: the first pairs of the tabletop scene
PLAN_EDGE = 1e-5          # miss and jerk predicates compared this far from their thresholds
PLAN_TRAJ_TOL = 1e-4      # planned trajectories, card against CPU (120 f32 optimizer steps;
                          # the CPU against the JAX package: 1.67e-6, tests/test_torch_expert.py)
HINDSIGHT_TOL = 1e-5      # a pickled target against the CPU's FK of its trajectory's last q
DAGGER_INTERVAL = 3       # the trainer's actor_interval
DAGGER_STEPS = 20         # actor_rollout_steps (the config's default)
DAGGER_B = 16             # the real collector's batch
DAGGER_OPT_STEPS = 60     # the config's dagger_opt_steps


def run_expert_pipeline(smi, dev):
    """The expert pipeline on ``dev`` (``mpinets_torch.pipeline``): one
    ``plan_scene`` at gen's defaults on the first kept scene of each
    environment (numpy seed SEED, as the scene-generation phase), the
    dresser's once more with a PRM seed at the full PRM size and its peak
    memory, card against CPU on the tabletop's first PLAN_CHECK_PAIRS pairs
    with the same draws, the device's busy share of one ``plan_scene``, and
    ``gen`` (2 tabletop scenes, every kept scene held out for the problem
    pickle) with the pickle read back. -> (summary, {env: (trajectories,
    scene arrays)}) for the DAgger phase."""
    from pathlib import Path

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpinets_torch import envs
    from mpinets_torch.data import problems as problem_io
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.pipeline import expert, gen

    summary, kept, calls = {}, {}, []
    plan = expert.plan_pair_optimized

    def timed_plan(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, args))
        return res

    def plan_scene(env, rng, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(expert, "plan_pair_optimized", timed_plan):
            trajs, arrays, stats = gen.plan_scene(env, rng, PLAN_CANDIDATES, False, **kwargs)
        wall = time.perf_counter() - t0
        plan_s = calls[-1][0]
        out = {**stats, "plan_s": plan_s, "plan_scene_s": wall,
               "pairs_per_s": stats["pairs"] / plan_s,
               "valid_rate": stats["valid"] / max(stats["pairs"], 1),
               "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        tallies = {k: stats[k] for k in ("miss", "jerk", "self_collision", "env_collision",
                                         "limit_violation")}
        log(f"  {type(env).__name__}: {stats['valid']}/{stats['pairs']} valid "
            f"({out['valid_rate']:.3f}); planner {plan_s:.3f} s ({out['pairs_per_s']:.2f} "
            f"pairs/s), plan_scene {wall:.3f} s with its candidate IK; failure tallies "
            f"{tallies}; peak memory {out['peak_gb']:.2f} GiB [{smi}]")
        return trajs, arrays, out

    for name, cls in envs.ENVIRONMENTS.items():
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        for attempt in range(SCENES_PER_ENV):
            env = cls(device=dev)
            if env.gen(rng):
                break
        else:
            raise AssertionError(f"{name}: no scene kept of {SCENES_PER_ENV}")
        log(f"  {name}: scene kept at attempt {attempt + 1} in {time.perf_counter() - t0:.2f} s")
        trajs, arrays, stats = plan_scene(env, rng)
        if not np.isfinite(trajs).all() or trajs.shape[1:] != (expert.SEQUENCE_LENGTH, 7):
            raise AssertionError(f"{name}: trajectories {trajs.shape}, finite "
                                 f"{np.isfinite(trajs).all()}")
        summary[name] = stats
        kept[name] = (env, rng, trajs, arrays, calls[-1][1])
    if not any(len(k[2]) for k in kept.values()):
        raise AssertionError("the expert pipeline planned no valid trajectory")

    # the lazy PRM at its full size (126 nodes, k=14, 6 edge samples) on the dresser
    env, rng = kept["dresser"][:2]
    _, _, summary["dresser_n_prm_1"] = plan_scene(env, rng, plan_kwargs={"n_prm": 1})

    # card against CPU, the same draws
    args = kept["tabletop"][4]
    qs, qg, rot, trans = (a[:PLAN_CHECK_PAIRS] for a in args[:4])
    scene = args[4]
    scene_cpu = SceneSet(*(t.cpu() for t in scene))
    draws = expert.draw_plan(qs, qg)
    draws_cpu = expert.draw_plan(qs.cpu(), qg.cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(draws[:2], draws_cpu[:2])):
        raise AssertionError("expert: the card's draws differ from the CPU's")
    got = plan(qs, qg, rot, trans, scene, draws=draws)
    t0 = time.perf_counter()
    ref = plan(qs.cpu(), qg.cpu(), rot.cpu(), trans.cpu(), scene_cpu, draws=draws_cpu)
    cpu_s = time.perf_counter() - t0
    traj_err = float((got.trajectory.cpu() - ref.trajectory).abs().max())
    same = (torch.equal(got.valid.cpu(), ref.valid) and torch.equal(got.which.cpu(), ref.which))
    log(f"  card vs CPU, {PLAN_CHECK_PAIRS} tabletop pairs: valid {got.valid.tolist()} / "
        f"{ref.valid.tolist()}, which {got.which.tolist()} / {ref.which.tolist()}, "
        f"trajectories within {traj_err:.3g} (gate {PLAN_TRAJ_TOL}); the CPU's plan took "
        f"{cpu_s:.1f} s")
    if not (same and traj_err <= PLAN_TRAJ_TOL):
        raise AssertionError("expert: the card's plans differ from the CPU's")
    ver_g = expert.verify_trajectory(got.trajectory, rot, trans, scene)
    ver_c = expert.verify_trajectory(got.trajectory.cpu(), rot.cpu(), trans.cpu(), scene_cpu)
    away = (((ver_c.miss - expert.MISS_TOLERANCE).abs() > PLAN_EDGE)
            & ((ver_c.max_jerk - expert.MAX_JERK).abs() > PLAN_EDGE))
    for field in ("valid", "has_self_collision", "has_env_collision", "within_limits"):
        a, b = getattr(ver_g, field).cpu(), getattr(ver_c, field)
        if not torch.equal(a[away] if field == "valid" else a, b[away] if field == "valid" else b):
            raise AssertionError(f"expert: predicate {field} differs between card and CPU")
    summary["card_vs_cpu"] = {"pairs": PLAN_CHECK_PAIRS, "trajectory_err": traj_err,
                              "valid": got.valid.tolist(), "which": got.which.tolist()}

    # the device's busy share of one plan_scene
    env, rng = kept["tabletop"][:2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.plan_scene(env, rng, PLAN_CANDIDATES, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = kernel_rows(prof)
    busy_us = sum(e.self_device_time_total for e in rows)
    summary["plan_scene_busy_share"] = busy_us / 1e6 / wall
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    log(f"  profile of one tabletop plan_scene: wall {wall * 1e3:.1f} ms, device kernel time "
        f"{busy_us / 1e3:.1f} ms in {sum(e.count for e in rows)} kernels, busy share "
        f"{busy_us / 1e6 / wall:.3f} (the profile's "
        f"{len(prof.events())} events took {time.perf_counter() - t0:.1f} s to read); top kernels "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms" for e in top)
        + f" [{smi}]")

    # gen: 2 tabletop scenes, each held out for the problem pickle (no HDF5)
    seen = []
    hindsight = gen.hindsight_problems
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gen_") as tmp, \
            mock.patch.object(gen, "hindsight_problems",
                              lambda t, e: seen.append(t) or hindsight(t, e)):
        t0 = time.perf_counter()
        stats = gen.gen("tabletop", tmp, num_scenes=2, eval_every=1,
                        inference_pkl=f"{tmp}/problems.pkl", device=dev)
        t_gen = time.perf_counter() - t0
        problems = problem_io.load_problems(f"{tmp}/problems.pkl")["tabletop"]["task-oriented"]
        written = sorted(p.name for p in Path(tmp).iterdir())
    trajs = np.concatenate(seen) if seen else np.zeros((0, expert.SEQUENCE_LENGTH, 7))
    if not (len(problems) == len(trajs) == stats["eval_problems"] == stats["valid"] > 0
            and written == ["problems.pkl"]):
        raise AssertionError(f"gen: {len(problems)} problems, {len(trajs)} trajectories, "
                             f"stats {stats}, files {written}")
    _, ee = kinematics.eff_pose(torch.as_tensor(trajs[:, -1]))
    target_err = max(float(np.abs(p.target.position - e).max()) for p, e in zip(problems, ee.numpy()))
    q0_equal = all(np.array_equal(p.q0, t[0]) for p, t in zip(problems, trajs))
    log(f"  gen tabletop, 2 scenes, eval_every=1: {stats['valid']}/{stats['pairs']} valid in "
        f"{t_gen:.2f} s; {len(problems)} problems read back, targets within {target_err:.3g} of "
        f"the CPU's FK of the last q (gate {HINDSIGHT_TOL}), q0 equal {q0_equal} [{smi}]")
    if not (target_err <= HINDSIGHT_TOL and q0_equal):
        raise AssertionError("gen: a pickled problem differs from its trajectory")
    summary["gen"] = {"s": t_gen, "pairs": stats["pairs"], "valid": stats["valid"],
                      "problems": len(problems), "target_err": target_err}
    return summary, {name: k[2:4] for name, k in kept.items()}


def dagger_problem_batch(planned, b):
    """A real collector's batch of ``b`` rows from the expert phase's valid
    trajectories, the environments taken in turn, each row with its scene
    (primitive axes padded with zero-volume rows, identity quaternions)."""
    import numpy as np

    rows, it = [], {k: 0 for k in planned}
    while len(rows) < b:
        for name, (trajs, arrays) in planned.items():
            if len(trajs) and len(rows) < b:
                i = it[name] % len(trajs)
                rows.append((trajs[i], {k: v[i] for k, v in arrays.items()}))
                it[name] += 1
    width = {k: max(r[1][k].shape[0] for r in rows) for k in rows[0][1]}

    def pad(k, v):
        out = np.zeros((width[k],) + v.shape[1:])
        if k.endswith("quats"):
            out[:, 0] = 1.0
        out[: len(v)] = v
        return out

    traj = np.stack([r[0] for r in rows]).astype(np.float32)
    batch = {k: np.stack([pad(k, r[1][k]) for r in rows]).astype(np.float32) for k in width}
    return {"expert": traj, "raw_configuration": traj[:, 0], "raw_goal": traj[:, -1], **batch}


def run_dagger(smi, dev, planned, count_path):
    """The DAgger actors on ``dev``: the trainer at the reference widths,
    synthetic data, bf16, ``actor_interval`` DAGGER_INTERVAL (collects at
    steps 3, 6 and 9, each launching the kernels), then the real collector
    at B=DAGGER_B on the expert phase's trajectories. -> summary."""
    import numpy as np
    import torch

    from mpinets_torch.cli.config import load_config
    from mpinets_torch.kernels import ops
    from mpinets_torch.train import actor
    from mpinets_torch.train.trainer import Trainer

    summary, collects = {}, []
    make = actor.make_dagger_collector

    def counted(*args, **kwargs):
        collect = make(*args, **kwargs)

        def run(*cargs, **ckwargs):
            before = dict(ops.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = collect(*cargs, **ckwargs)
            torch.cuda.synchronize()
            collects.append((time.perf_counter() - t0,
                             {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
                              if v - before.get(k, 0)}))
            return out

        return run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dagger_") as tmp:
        cfg = load_config(None, {"optim": {"bf16": True}, "save_checkpoint_dir": tmp,
                                 "seed": SEED,
                                 "rollout": {"actor_interval": DAGGER_INTERVAL,
                                             "actor_rollout_steps": DAGGER_STEPS}})
        cfg.data.synthetic = True
        ops.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(actor, "make_dagger_collector", counted):
            trainer = Trainer(cfg, test=True, device=dev)
            state = trainer.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        count_path("dagger actor", ("fps", "sa_select", "sa"))
        rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
    act = [r for r in rows if "actor_val_loss" in r]
    if not (state.step == 13 and [r["step"] for r in act] == [3, 6, 9] and len(collects) == 3
            and all(np.isfinite(v) for r in rows for v in r.values())):
        raise AssertionError(f"dagger actor: step {state.step}, actor rows {act}")
    for dt, launches in collects:
        if not all(launches.get(k) for k in ("fps", "sa_select", "sa")):
            raise AssertionError(f"dagger actor: a collect launched {launches}")
    b = cfg.optim.batch_size
    summary["synthetic"] = {
        "batch": b, "rollout_steps": DAGGER_STEPS, "collect_s": [c[0] for c in collects],
        "actor_env_steps_per_s": [r["actor_env_steps_per_s"] for r in act],
        "actor_learner_samples_per_s": [r["actor_learner_samples_per_s"] for r in act],
        "run_s": t_run, "launches_per_collect": collects[-1][1]}
    log(f"  trainer, synthetic, B={b}, actor_interval={DAGGER_INTERVAL}, {DAGGER_STEPS} rollout "
        f"steps: 10 steps + 3 actor steps + 5 validations in {t_run:.1f} s; collects "
        + ", ".join(f"{c[0] * 1e3:.1f}" for c in collects) + " ms; actor_env_steps_per_s "
        + ", ".join(f"{r['actor_env_steps_per_s']:.1f}" for r in act)
        + f"; actor losses {[round(r['actor_val_loss'], 4) for r in act]}; launches per "
        f"collect {collects[-1][1]} [{smi}]")

    # the real collector on the expert phase's trajectories
    batch = dagger_problem_batch(planned, DAGGER_B)
    collect = actor.make_real_dagger_collector(state.model, DAGGER_STEPS,
                                               opt_steps=DAGGER_OPT_STEPS, device=dev)
    ops.reset_launches()
    times = []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = collect(batch, torch.Generator(dev).manual_seed(SEED + rep))
        accept = float(info["dagger_accept_frac"])
        times.append(time.perf_counter() - t0)
        if not (all(bool(torch.isfinite(v).all()) for v in out.values())
                and out["xyz"].shape == (DAGGER_B, 6272, 4)
                and float(out["supervision"].abs().max()) <= 1.0 + 1e-5):
            raise AssertionError("real DAgger collector: a bad batch")
        if rep == 0:
            count_path("real DAgger collector", ("fps", "sa_select", "sa"))
    # the same batch under a policy that stands still: every visited state is
    # the expert's start, so the acceptance is the optimizer's own from there
    standing = actor.make_real_dagger_collector(
        state.model, DAGGER_STEPS, apply_fn=lambda m, xyz, q: torch.zeros_like(q),
        opt_steps=DAGGER_OPT_STEPS, device=dev)
    accept_standing = float(standing(batch, torch.Generator(dev).manual_seed(SEED))[1][
        "dagger_accept_frac"])
    summary["real"] = {"batch": DAGGER_B, "opt_steps": DAGGER_OPT_STEPS, "collect_s": times,
                       "dagger_accept_frac": accept,
                       "dagger_accept_frac_standing_policy": accept_standing}
    log(f"  real collector, B={DAGGER_B}, {DAGGER_STEPS} rollout steps, {DAGGER_OPT_STEPS} "
        f"optimizer steps: {times[0]:.3f} s, again {times[1]:.3f} s; dagger_accept_frac "
        f"{accept:.4f} (random weights), {accept_standing:.4f} under a policy that stands at "
        f"the expert's start [{smi}]")
    return summary


DP_MIN_S = 2.0            # seconds of timed data-parallel steps per batch size and rate
DP_VAL_ROWS = 16          # validation problems of the data-parallel phase
DP_STATS_STEPS = 150      # make_sharded_success_stats' default max_steps
PREPARE_TOL = 1e-5        # prepare_train_batch, card vs CPU on the same draws


def dataset_arrays(planned, rows=None):
    """The expert phase's trajectories and scenes as one split in the disk
    schema (``data.writer``'s keys: ``hybrid_solutions``,
    ``cuboid_quaternions``, ...), primitive axes padded with zero rows as
    ``data.process.merge_files`` pads them; the first ``rows`` rows."""
    import numpy as np

    from mpinets_torch.data.writer import DISK_KEYS

    parts = [(t, a) for t, a in planned.values() if len(t)]
    width = {k: max(a[k].shape[1] for _, a in parts) for k in parts[0][1]}

    def pad(k, v):
        out = np.zeros((v.shape[0], width[k]) + v.shape[2:])
        out[:, : v.shape[1]] = v
        return out

    trajs = np.concatenate([t for t, _ in parts]).astype(np.float64)[:rows]
    out = {"hybrid_solutions": trajs, "global_solutions": trajs}
    for k in width:
        out[DISK_KEYS[k]] = np.concatenate([pad(k, a[k]) for _, a in parts])[:rows]
    return out


def run_data_parallel(smi, dev, planned, count_path):
    """Data-parallel training on the dataset layout at world size 1 on
    NCCL: the process group through ``parallel.mesh.multihost_init``, the
    train and validation splits in the disk schema from the expert phase's
    trajectories (``TrajectoryDataset._from_arrays``), then ``InstanceLoader``
    -> ``prepare_train_batch`` on the card -> ``make_data_parallel_step``
    with the kernel forward at B=10 and 64 (bf16), checks of the prepared
    batch (card vs CPU on the same draws) and of an f32 DP step's gradients
    (vs ``make_train_step``), the sharded success statistics on the
    validation split (vs the plain rollout on the same draws), one
    hdf5-actor collect and its DP step, and ``Trainer.run`` in hdf5 mode
    where h5py imports. -> summary."""
    import functools
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from mpinets_torch.cli.config import load_config
    from mpinets_torch.data import hdf5, synthetic, writer
    from mpinets_torch.kernels import kinematics, ops
    from mpinets_torch.model.fused import make_fused_apply
    from mpinets_torch.model.fused_train import make_fused_train_apply
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.parallel import mesh as pmesh
    from mpinets_torch.parallel.rollout import STAT_KEYS, make_sharded_success_stats
    from mpinets_torch.rollout.engine import make_rollout_fn
    from mpinets_torch.train import actor, learner
    from mpinets_torch.train.trainer import Trainer

    bf16, f32 = torch.bfloat16, torch.float32
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if not pmesh.multihost_init(f"localhost:{port}", 1, 0, device=dev):
        raise AssertionError("data-parallel: multihost_init made no process group")
    summary = {}
    try:
        mesh = pmesh.make_mesh()
        group = mesh.get_group("data")
        log(f"  process group: backend {dist.get_backend()}, world size {dist.get_world_size()}, "
            f"mesh {mesh}")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("data-parallel: not an NCCL group of world size 1")
        train = hdf5.TrajectoryDataset._from_arrays(dataset_arrays(planned))
        val = hdf5.TrajectoryDataset._from_arrays(dataset_arrays(planned, DP_VAL_ROWS),
                                                  dataset_type=hdf5.DatasetType.VAL)
        log(f"  splits in the disk schema: train {train.num_trajectories} trajectories "
            f"({train.num_instances} instances, {train.max_cuboids} cuboid and "
            f"{train.max_cylinders} cylinder slots), val {val.num_trajectories}")
        summary["train_trajectories"] = train.num_trajectories

        # prepare_train_batch: the card against the CPU on the same draws
        raw_cpu = hdf5.to_device(train.read_instance_batch(
            np.arange(64) % train.num_trajectories, np.arange(64) % train.expert_length), "cpu")
        draws = hdf5.draw_prepare(torch.Generator().manual_seed(SEED), raw_cpu)
        ref = hdf5.prepare_train_batch(raw_cpu, draws=draws)
        got = hdf5.prepare_train_batch(hdf5.to_device(raw_cpu, dev), draws=draws)
        err = max(float((got[k].cpu() - v).abs().max()) for k, v in ref.items())
        log(f"  prepare_train_batch B=64, card vs CPU on the same draws: max abs err {err:.3g} "
            f"(gate {PREPARE_TOL})")
        if not err <= PREPARE_TOL:
            raise AssertionError("prepare_train_batch: the card differs from the CPU")
        raw64 = hdf5.to_device(raw_cpu, dev)
        pgen = torch.Generator(dev).manual_seed(SEED)
        summary["prepare_ms_b64"] = cuda_ms(lambda: hdf5.prepare_train_batch(raw64, pgen), 10)
        summary["training_batch_ms_b64"] = cuda_ms(
            lambda: synthetic.training_batch(pgen, 64, device=dev), 10)
        summary["prepare_err"] = err
        log(f"  prepare_train_batch B=64: {summary['prepare_ms_b64']:.3f} ms; the synthetic "
            f"trainer's training_batch B=64: {summary['training_batch_ms_b64']:.3f} ms [{smi}]")
        phase("profile: prepare_train_batch, B=64 (torch.profiler)")
        profile_rollout(lambda *_: hdf5.prepare_train_batch(raw64, pgen), None, None, top=8)

        # the gradient all-reduce of the full model, alone
        model = MotionPolicyNetwork(compute_dtype=bf16, device=dev,
                                    generator=torch.Generator().manual_seed(SEED))
        numel = sum(p.numel() for p in model.parameters())
        flat = torch.zeros(numel + 4, device=dev)
        summary["allreduce_ms"] = cuda_ms(lambda: dist.all_reduce(flat, group=group), 20)
        log(f"  all-reduce of {numel + 4} f32 ({(numel + 4) * 4 / 1e6:.1f} MB, the gradients and "
            f"4 metrics), NCCL, world size 1: {summary['allreduce_ms']:.4f} ms [{smi}]")

        # one f32 DP step against make_train_step: gradients within the gate
        grads, metrics = [], []
        for make in (learner.make_train_step, functools.partial(
                learner.make_data_parallel_step, mesh)):
            m32 = MotionPolicyNetwork(compute_dtype=f32, device=dev,
                                      generator=torch.Generator().manual_seed(SEED + 1))
            st = learner.init_state(m32)
            st, met = make(apply_fn=make_fused_train_apply(f32))(st, got)
            grads.append([p.grad.clone() for p in m32.parameters()])
            metrics.append({k: float(v) for k, v in met.items()})
        g_err = max(float(((a - b).abs() - (GRAD_ATOL + GRAD_RTOL * b.abs().max())).max())
                    for a, b in zip(*reversed(grads)))
        log(f"  f32 DP step vs make_train_step, B=64: worst gradient excess over the gate "
            f"{g_err:.3g} (<= 0 holds); losses {metrics[1]['val_loss']:.6f} / "
            f"{metrics[0]['val_loss']:.6f}")
        if g_err > 0 or abs(metrics[1]["val_loss"] - metrics[0]["val_loss"]) > 1e-5 * abs(
                metrics[0]["val_loss"]):
            raise AssertionError("the f32 DP step differs from make_train_step")

        # the training path: loader -> prepare on the card -> DP step, bf16
        state = learner.init_state(model)
        learner.broadcast_state(state, mesh)
        apply = make_fused_train_apply(bf16)
        prepare = hdf5.prepare_train_batch
        dp_step = learner.make_data_parallel_step(mesh, prepare_fn=prepare, apply_fn=apply)
        dp_core = learner.make_data_parallel_step(mesh, apply_fn=apply)
        plain_step = learner.make_train_step(apply_fn=apply)
        rates = {}
        for b_ in TRAIN_BATCHES:
            stream = iter(hdf5.InstanceLoader(train, b_, seed=SEED, pin_memory=True))
            holder = [state]
            counter = [0]

            def step(raw):
                counter[0] += 1
                holder[0], out = dp_step(holder[0], raw, pmesh.fold_seed(SEED, counter[0]))
                return out

            def on_batch(step_fn):
                holder[0] = step_fn(holder[0], batch)[0]

            ops.reset_launches()
            for _ in range(3):
                metrics = step(hdf5.to_device(next(stream), dev))
            torch.cuda.synchronize()
            count_path(f"data-parallel train B={b_}", ("fps", "sa_select", "sa_raw", "sa_bwd"))
            if not all(np.isfinite(float(v)) for v in metrics.values()):
                raise AssertionError(f"data-parallel train B={b_}: {metrics}")
            raw = hdf5.to_device(next(stream), dev)
            batch = prepare(raw, torch.Generator(dev).manual_seed(SEED))
            timed = {
                "loader_prepare_step": step_times(
                    lambda: step(hdf5.to_device(next(stream), dev)), DP_MIN_S, TRAIN_CHUNK),
                "prepare_step": step_times(lambda: step(raw), DP_MIN_S, TRAIN_CHUNK),
                "dp_step": step_times(lambda: on_batch(dp_core), DP_MIN_S, TRAIN_CHUNK),
                "train_step": step_times(lambda: on_batch(plain_step), DP_MIN_S, TRAIN_CHUNK),
            }
            stream.close()
            state = holder[0]
            r = {}
            for key, ts in timed.items():
                samples = sorted(b_ / t for t in ts)
                r[f"{key}_samples_per_s_median"] = float(np.median(samples))
                r[f"{key}_samples_per_s_min"] = samples[0]
                r[f"{key}_samples_per_s_max"] = samples[-1]
                r[f"{key}_ms_median"] = float(np.median(ts)) * 1e3
            rates[b_] = r
            log(f"  B={b_}, bf16, samples/s median (min, max) of chunks of {TRAIN_CHUNK}: "
                + "; ".join(f"{k} {r[k + '_samples_per_s_median']:.1f} "
                            f"({r[k + '_samples_per_s_min']:.1f}, "
                            f"{r[k + '_samples_per_s_max']:.1f}), "
                            f"{r[k + '_ms_median']:.2f} ms" for k in timed)
                + f" [{smi}]")
        summary["rates"] = {str(k): v for k, v in rates.items()}

        # the sharded success statistics on the validation split
        vb = val.read_trajectory_batch(np.arange(val.num_trajectories))
        rot, trans = kinematics.eff_pose(torch.as_tensor(vb["raw_goal"], device=dev))
        problems = synthetic.Problem(torch.as_tensor(vb["raw_configuration"], device=dev), rot,
                                     trans, hdf5.scene_from_arrays(vb, dev))
        stats_fn = make_sharded_success_stats(model, mesh, max_steps=DP_STATS_STEPS, device=dev)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = {k: float(v) for k, v in stats_fn(problems, SEED).items()}
        torch.cuda.synchronize()
        summary["success_stats_s"] = time.perf_counter() - t0
        count_path(f"sharded success stats B={val.num_trajectories}", ("fps", "sa_select", "sa"))
        plain = make_rollout_fn(model, max_steps=DP_STATS_STEPS, stop_on_success=True,
                                record_trajectory=False, apply_fn=make_fused_apply(bf16),
                                device=dev)(problems, pmesh.rank_generator(SEED, 0, dev))
        _, ee = kinematics.eff_pose(plain.final_q)
        ref_stats = dict(zip(STAT_KEYS, (plain.success.float().mean().item(),
                                         plain.num_steps.float().mean().item(),
                                         torch.linalg.norm(ee - trans, dim=-1).mean().item())))
        s_err = max(abs(stats[k] - ref_stats[k]) for k in STAT_KEYS)
        log(f"  make_sharded_success_stats, {val.num_trajectories} validation problems, "
            f"{DP_STATS_STEPS} steps: {stats} in {summary['success_stats_s']:.3f} s; the plain "
            f"rollout on the same draws {ref_stats} (max diff {s_err:.3g}) [{smi}]")
        if s_err > 1e-6:
            raise AssertionError("sharded success stats differ from the plain rollout's")
        summary["success_stats"] = stats

        # one hdf5-actor collect (the trainer's draw of training trajectories)
        # and its DP step
        collect = actor.make_real_dagger_collector(model, DAGGER_STEPS,
                                                   opt_steps=DAGGER_OPT_STEPS, device=dev)
        idx = np.random.default_rng(SEED + 0xDA66).integers(0, train.num_trajectories,
                                                            size=DAGGER_B)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dagger, info = collect(hdf5.to_device(train.read_trajectory_batch(idx), dev),
                               torch.Generator(dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t_collect = time.perf_counter() - t0
        state, a_metrics = dp_core(state, dagger)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0 - t_collect
        count_path(f"hdf5-actor collect B={DAGGER_B} and its DP step",
                   ("fps", "sa_select", "sa", "sa_raw", "sa_bwd"))
        if not all(np.isfinite(float(v)) for v in a_metrics.values()):
            raise AssertionError(f"hdf5-actor DP step: {a_metrics}")
        summary["actor"] = {"collect_s": t_collect, "step_s": t_step,
                            "dagger_accept_frac": float(info["dagger_accept_frac"])}
        log(f"  hdf5-actor collect, B={DAGGER_B}, {DAGGER_STEPS} rollout steps, "
            f"{DAGGER_OPT_STEPS} optimizer steps: {t_collect:.3f} s, its DP step "
            f"{t_step * 1e3:.1f} ms; dagger_accept_frac "
            f"{summary['actor']['dagger_accept_frac']:.4f}; actor loss "
            f"{float(a_metrics['val_loss']):.5f} [{smi}]")

        # Trainer.run in hdf5 mode with the actor, on a file, where h5py imports
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            log(f"  h5py does not import here ({e!r}): the HDF5 file reader and Trainer.run in "
                "hdf5 mode were not run; everything behind the reader ran above, from arrays in "
                "the disk schema")
            summary["trainer_hdf5"] = None
        else:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_hdf5_") as tmp:
                writer.write_synthetic_dataset(f"{tmp}/data", "train", num_trajectories=32,
                                               seed=SEED)
                writer.write_synthetic_dataset(f"{tmp}/data", "val", num_trajectories=8,
                                               seed=SEED + 1)
                cfg = load_config(None, {"optim": {"bf16": True}, "save_checkpoint_dir": tmp,
                                         "seed": SEED, "data": {"data_dir": f"{tmp}/data"},
                                         "rollout": {"actor_interval": DAGGER_INTERVAL,
                                                     "actor_rollout_steps": DAGGER_STEPS}})
                ops.reset_launches()
                t0 = time.perf_counter()
                trainer = Trainer(cfg, test=True, device=dev)
                st = trainer.run()
                torch.cuda.synchronize()
                count_path("trainer, hdf5 mode with the actor", ("fps", "sa_select", "sa",
                                                                  "sa_raw", "sa_bwd"))
                rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
            act = [r for r in rows if "dagger_accept_frac" in r]
            if st.step != 13 or [r["step"] for r in act] != [3, 6, 9]:
                raise AssertionError(f"trainer, hdf5 mode: step {st.step}, actor rows {act}")
            summary["trainer_hdf5"] = {"s": time.perf_counter() - t0}
            log(f"  Trainer.run, hdf5 mode with the actor, B=10: 13 steps in "
                f"{summary['trainer_hdf5']['s']:.1f} s")
    finally:
        dist.destroy_process_group()
    return summary


# ---- the real weights on the card: the committed orbax checkpoint -----------
CHECKPOINT = "checkpoints/r5_ft_best_ema"   # the JAX package's orbax tree, bf16 (beside this file)
REAL_B = 8                # batch of the forward gates, full widths
REAL_F32_ATOL, REAL_F32_RTOL = 2e-5, 1e-4   # f32 kernel path vs plain policy (the CPU tests' gate)
REAL_RUNS = (             # cli.infer on the evaluation phase's 64 problems: label, flags, kernels
    ("bf16, exact", ["--batch-size", "32"], ("fps", "sa_select", "sa")),
    ("--fp32", ["--fp32", "--batch-size", "32"], ("fps", "sa_select", "sa_f32")),
)


def run_real_weights(smi, dev, count_path):
    """The trained weights through the entry points a user calls: read the
    orbax directory without JAX (``cli.infer.load_params``), hold the
    forward at full widths against the plain versions, serve 3 requests
    (``cli.serve --checkpoint``), evaluate the problem set in bf16 and f32
    (``cli.infer``), and compare the metric pickles
    (``python -m mpinets_torch.eval.compare``). -> summary."""
    import pickle
    from pathlib import Path

    import numpy as np
    import torch

    from mpinets_torch.cli import infer, serve
    from mpinets_torch.data import problems as P
    from mpinets_torch.data.synthetic import random_configuration, random_problem_batch
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import kinematics, ops
    from mpinets_torch.model import fused
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.robot import franka
    from mpinets_torch.utils.normalization import normalize_franka_joints

    root = Path(__file__).resolve().parent
    ckpt = root / CHECKPOINT
    summary = {}
    t0 = time.perf_counter()
    params = infer.load_params(ckpt)
    summary["load_s"] = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    if not 19_000_000 < n_params < 19_300_000 or len(params) != 46:
        raise AssertionError(f"real weights: {len(params)} tensors, {n_params} parameters")
    log(f"real weights: {ckpt.name} read without JAX in {summary['load_s']:.2f} s: "
        f"{len(params)} tensors, {n_params} parameters")

    models = {}
    for cdt in (torch.float32, torch.bfloat16):
        m = MotionPolicyNetwork(compute_dtype=cdt, device="cpu")
        m.load_state_dict(params)
        models[cdt] = m.to(dev).eval()
    g = torch.Generator(dev).manual_seed(SEED + 11)
    problem = random_problem_batch(g, REAL_B, device=dev)
    with torch.no_grad():
        pc = assemble_point_cloud(problem.q0, problem.target_rot, problem.target_trans,
                                  problem.scene, generator=g)
        q = normalize_franka_joints(problem.q0)
        oracle = models[torch.float32](pc, q)
    kern32 = fused.fused_policy_apply(models[torch.float32], pc, q, compute_dtype=torch.float32)
    err32 = float((kern32 - oracle).abs().max())
    log(f"real weights, B={REAL_B}, 6272 points, SA 512/128: f32 kernel path vs plain policy "
        f"max |dq err| {err32:.3e}, max |dq| {float(oracle.abs().max()):.4f}")
    if not torch.allclose(kern32, oracle, atol=REAL_F32_ATOL, rtol=REAL_F32_RTOL):
        raise AssertionError(f"real weights: f32 forward error {err32}")
    kern16 = fused.fused_policy_apply(models[torch.bfloat16], pc, q,
                                      compute_dtype=torch.bfloat16)
    ref16 = plain_policy_path(models[torch.bfloat16], pc, q, torch.bfloat16)
    err16, scale = float((kern16 - ref16).abs().max()), float(ref16.abs().max())
    log(f"real weights: bf16 kernel path vs plain path max |dq err| {err16:.3e} "
        f"({err16 / max(scale, 1e-3):.4f} of max |dq| {scale:.4f}); bf16 vs f32 plain "
        f"{float((kern16 - oracle).abs().max()):.3e}")
    if not (torch.isfinite(kern16).all() and err16 <= FWD_BF16_TOL * max(scale, 1e-3)):
        raise AssertionError(f"real weights: bf16 forward error {err16}")
    summary["forward"] = {"f32_err": err32, "bf16_err": err16, "max_dq": scale}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "scan.npy", tabletop_scan(np.random.default_rng(SEED)))
        requests = []
        for _ in range(3):
            q0 = random_configuration(g, (), dev)
            pos, quat = kinematics.eff_pose_quat(random_configuration(g, (), dev))
            requests.append(json.dumps({"q0": q0.tolist(), "target_position": pos.tolist(),
                                        "target_quaternion": quat.tolist()}))
        out = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(sys, "stdin", io.StringIO("\n".join(requests) + "\n")), \
                contextlib.redirect_stdout(out):
            serve.main(["--checkpoint", str(ckpt), str(tmp / "scan.npy")])
        torch.cuda.synchronize()
        summary["serve_s"] = time.perf_counter() - t0
        count_path("server, real weights", ("fps", "sa_select", "sa"))
        lo, hi = franka.JOINT_LIMITS[:, 0] - 1e-4, franka.JOINT_LIMITS[:, 1] + 1e-4
        answers = [json.loads(line) for line in out.getvalue().splitlines()]
        if len(answers) != 3:
            raise AssertionError(f"server, real weights: {len(answers)} answers to 3 requests")
        for resp in answers:
            traj = np.asarray(resp.get("trajectory", []))
            if traj.shape != (resp.get("num_steps", -2) + 1, 7) or not (
                    np.isfinite(traj).all() and (traj >= lo).all() and (traj <= hi).all()):
                raise AssertionError(f"server, real weights: bad answer {sorted(resp)}")
        summary["serve"] = [(r["success"], r["num_steps"]) for r in answers]
        log(f"server, real weights: 3 requests in {summary['serve_s']:.2f} s (loading "
            f"included), (success, steps) {summary['serve']} [{smi}]")

        P.save_problems(tmp / "problems.pkl", eval_problem_set(np.random.default_rng(SEED + 7)))
        pickles = {}
        for label, flags, kernels in REAL_RUNS:
            out_dir = tmp / f"metrics_{len(pickles)}"
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ev = infer.main([str(ckpt), str(tmp / "problems.pkl"), "all", "all",
                                 "--save-metrics", str(out_dir), *flags])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            count_path(f"evaluation, real weights, {label}", kernels)
            pickles[label] = out_dir / "mpinets_torch_eval_metrics.pkl"
            with open(pickles[label], "rb") as f:
                saved = pickle.load(f)
            success = [bool(s) for group in saved.values() for s in group["success"]]
            if len(success) != 2 * EVAL_GROUP:
                raise AssertionError(f"evaluation, real weights, {label}: {len(success)} rows")
            rows = {k: {m: float(ev.metrics(gr)[m]) for m in ("success", "env collision", "1 cm")}
                    for k, gr in saved.items()}
            summary[label] = {"seconds": seconds, "success_share": float(np.mean(success)),
                              "groups": rows}
            log(f"evaluation, real weights, {label}: {len(success)} problems in {seconds:.2f} s "
                f"(loading included), success share {np.mean(success):.4f}; by group {rows} "
                f"[{smi}]")

        def compare(a, b):
            return subprocess.run([sys.executable, "-m", "mpinets_torch.eval.compare", str(a),
                                   str(b)], capture_output=True, text=True, cwd=root,
                                  timeout=300)
        same = compare(pickles["bf16, exact"], pickles["bf16, exact"])
        log(f"eval.compare, the bf16 run against itself: exit {same.returncode}\n"
            + same.stdout.strip())
        if same.returncode != 0:
            raise AssertionError(f"eval.compare of a pickle with itself exited {same.returncode}"
                                 f": {same.stderr.strip()[-2000:]}")
        cross = compare(pickles["bf16, exact"], pickles["--fp32"])
        if cross.returncode not in (0, 1):
            raise AssertionError(f"eval.compare failed: {cross.stderr.strip()[-2000:]}")
        log(f"eval.compare, bf16 (ours) against --fp32 (theirs), a measurement: exit "
            f"{cross.returncode}\n" + cross.stdout.strip())
        summary["compare_bf16_vs_fp32_exit"] = cross.returncode
    return summary


# ---- the evaluation extras: calibration and the viewer --------------------
CAL_SAMPLES = 2048        # calibration's command-line size
CAL_NEAR = 1e-5           # card and CPU flags are compared where the clearance is farther
                          # than this from its threshold
VIEW_TOL = 1e-4           # the viewer's DATA (4 decimals) against the CPU's FK


def write_stl(path):
    """A synthetic binary STL in the right_gripper frame at the real
    gripper's extents (a box hand, two box fingers): it checks the hull
    path, it is no calibration (``tests/test_torch_eval_extras.py`` writes
    the same mesh)."""
    import struct

    import numpy as np

    def box(lo, hi):
        (x0, y0, z0), (x1, y1, z1) = lo, hi
        v = np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)])
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
                 (1, 5, 7, 3)]
        return [v[[a, b, c]] for a, b, c, d in quads] + [v[[a, c, d]] for a, b, c, d in quads]

    tris = (box((-0.03, -0.1, -0.126), (0.03, 0.1, -0.05))
            + box((-0.01, 0.06, -0.05), (0.01, 0.1, 0.012))
            + box((-0.01, -0.1, -0.05), (0.01, -0.06, 0.012)))
    with open(path, "wb") as f:
        f.write(b"synthetic gripper".ljust(80, b"\0") + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<12fH", 0.0, 0.0, 0.0, *np.asarray(t, np.float32).ravel(), 0))
    return str(path)


def run_eval_extras(smi, dev):
    """Calibration (bank, then hull at 0.9, 1.0 and 1.1 on a synthetic
    mesh) on the card against the CPU on the same draws, a missing mesh
    refused, and ``gen --visualize-scene`` on the card against the CPU's
    FK. -> summary."""
    from pathlib import Path

    import numpy as np
    import torch

    from mpinets_torch.eval import calibration as cal
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.pipeline import gen

    summary = {}
    draws = cal.draw_batches(CAL_SAMPLES, SEED, dev)
    cpu_draws = [d.to("cpu") for d in draws]

    def card_and_cpu(proxy, inflate, path=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = cal.clearances(draws, proxy, inflate, path)   # ends with the copy to the host
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = cal.clearances(cpu_draws, proxy, inflate, path)
        cpu_s = time.perf_counter() - t0
        near = {}
        for name, a, b in (("sphere", card[0], cpu[0]), (proxy, card[1], cpu[1])):
            far = (np.abs(a) > CAL_NEAR) & (np.abs(b) > CAL_NEAR)
            if not np.array_equal((a < 0)[far], (b < 0)[far]):
                raise AssertionError(f"calibration {proxy} {inflate}: {name} flags differ, "
                                     "card vs CPU")
            near[name] = int((~far).sum())
        worst = max(float(np.abs(card[i] - cpu[i]).max()) for i in (0, 1))
        result = cal.summarize(card[0] < 0, card[1] < 0, proxy, inflate)
        log(f"calibration {proxy} inflate {inflate}: {json.dumps(result)}; card {card_s:.3f} s, "
            f"CPU {cpu_s:.3f} s; card = CPU away from the threshold (rows within {CAL_NEAR}: "
            f"{near}), max |clearance card - CPU| {worst:.2e} [{smi}]")
        return {"summary": result, "card_s": card_s, "cpu_s": cpu_s, "near": near,
                "max_clearance_diff": worst}

    summary["bank"] = card_and_cpu("bank", 1.0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_extras_") as tmp:
        tmp = Path(tmp)
        try:
            cal.clearances(draws[:1], "hull", 1.0, str(tmp / "absent.stl"))
        except FileNotFoundError as e:
            log(f"calibration hull with a missing mesh: refused ({e})")
        else:
            raise AssertionError("calibration hull ran without its mesh")
        stl = write_stl(tmp / "gripper.stl")
        log("calibration hull on a synthetic gripper mesh: a check of the code path, not a "
            "calibration (the reference's mesh is not in the repository)")
        for inflate in (0.9, 1.0, 1.1):
            summary[f"hull_{inflate}"] = card_and_cpu("hull", inflate, stl)

        captured = {}
        real_write = gen.write_html

        def spy(path, trajectory, **kw):
            captured["traj"] = trajectory
            return real_write(path, trajectory, **kw)

        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(gen, "write_html", spy), contextlib.redirect_stdout(printed):
            gen.main(["tabletop", "--output", str(tmp / "gen"), "--visualize-scene",
                      str(tmp / "scene.html")])
        seconds = time.perf_counter() - t0
        traj = captured["traj"]
        if traj.device.type != "cuda" or traj.shape != (50, 7):
            raise AssertionError(f"viewer: trajectory {tuple(traj.shape)} on {traj.device}")
        html = (tmp / "scene.html").read_text()
        data = json.loads(html.split("const DATA = ", 1)[1].split(";\nconst views", 1)[0])
        with torch.no_grad():
            spheres = kinematics.collision_spheres(traj.cpu()).numpy()
            ee = kinematics.eff_pose(traj.cpu())[1].numpy()
        err = max(float(np.abs(np.asarray(data["spheres"]) - spheres).max()),
                  float(np.abs(np.asarray(data["ee"]) - ee).max()))
        plan_line = next(line for line in printed.getvalue().splitlines() if "valid=" in line)
        log(f"viewer: gen tabletop --visualize-scene on the card in {seconds:.2f} s; "
            f"{plan_line}; DATA vs the CPU's FK max |err| {err:.2e} (gate {VIEW_TOL}) [{smi}]")
        if not err <= VIEW_TOL:
            raise AssertionError(f"viewer: DATA differs from the CPU's FK by {err}")
        summary["viewer"] = {"seconds": seconds, "plan": plan_line, "max_err": err}
    return summary


# The port bench's runs: (label, argv, kernels each must launch, kernels it
# must not, its config beside BENCH_CONFIG).
BENCH_CONFIG = {"sa_impl": "v8", "fast_grouping": FAST_W, "fps_impl": "v1", "batch": B,
                "fused": True, "bf16_cloud": False, "compute_dtype": "bfloat16",
                "device": "cuda"}
BENCH_RUNS = (
    ("defaults", [], ("fps", "sa_select", "sa", "sa_fast"), ("sa_v3",), {}),
    ("--fast-grouping 0", ["--fast-grouping", "0"], ("fps", "sa_select", "sa"),
     ("sa_fast", "sa_v3"), {"fast_grouping": 0}),
    ("--sa-impl v3", ["--sa-impl", "v3"], ("fps", "sa_select", "sa_v3", "sa_fast"), ("sa",),
     {"sa_impl": "v3"}),
    ("--sweep", ["--sweep"], ("fps", "sa_select", "sa", "sa_fast"), ("sa_v3",),
     {"batch": 512}),
)


def run_port_bench(smi, dev, main_launches, sa_w, radii):
    """``mpinets_torch.bench.main`` in-process (``BENCH_RUNS``): each run's
    last line parsed and checked, each run's kernels launched; every
    (kernel, B, N, S) the sweep launched that ``main_launches`` does not
    hold, held against its plain version by ``time_at_shape`` on a 512-row
    cloud; ``--profile`` leaving its trace. The bench's launches stay out of
    ``main_launches``. -> summary."""
    from collections import Counter
    from pathlib import Path

    import torch

    from mpinets_torch import bench
    from mpinets_torch.data.synthetic import random_problem_batch
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import ops

    bf16 = torch.bfloat16
    nb = max(bench.SWEEP_BATCHES)
    log(f"  launch plans at B={nb}: fps 6272->512 {ops.fps_plan(nb, 6272)} "
        f"{ops.fps_plan_info(6272, 512, ops.fps_plan(nb, 6272), bf16)}, 512->128 "
        f"{ops.fps_plan(nb, 512)}; sa_select SA1 {ops.sa_select_plan(nb, 512, 128)}; "
        f"sa_fast SA0 {ops.sa_launch_plan(sa_w[bf16][0], 1, nb, 512, fast=True)}; "
        f"sa SA1 {ops.sa_launch_plan(sa_w[bf16][1], 64, nb, 128)}")

    def run(label, argv):
        ops.reset_launches()
        out, stdout = io.StringIO(), sys.stdout
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(stdout):
            bench.main(argv)
        seconds = time.perf_counter() - t0
        line = out.getvalue().strip().splitlines()[-1]
        log(f"port bench {label}: {seconds:.1f} s; launches "
            f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }; {line}")
        return json.loads(line), dict(ops.LAUNCHES_BY_SHAPE)

    summary, launched = {}, {}
    for label, argv, kernels, absent, config in BENCH_RUNS:
        res, launched[label] = run(label, argv)
        if res.get("metric") != "env_steps_per_s_per_chip" or not res["value"] > 0:
            raise AssertionError(f"port bench {label}: {res}")
        if "vs_baseline" in res or res["card"] != smi:
            raise AssertionError(f"port bench {label}: keys {sorted(res)}, card {res['card']}")
        if res["config"] != {**BENCH_CONFIG, **config}:
            raise AssertionError(f"port bench {label}: config {res['config']}")
        for k in kernels:
            if not ops.LAUNCHES[k]:
                raise AssertionError(f"port bench {label}: kernel {k} was not launched")
        for k in absent:
            if ops.LAUNCHES[k]:
                raise AssertionError(f"port bench {label}: kernel {k} was launched")
        summary[label] = {k: res[k] for k in ("value", "median", "rates")}
    log(f"port bench launches by (kernel, B, N, S), kept out of the main paths' totals: "
        + json.dumps({label: {" ".join(map(str, k)): v for k, v in sorted(shapes.items())}
                      for label, shapes in launched.items()}))

    sweep = launched["--sweep"]
    new = sorted(k for k in sweep if k not in main_launches)
    log(f"port bench: the sweep's shapes no main path launched: {new}")
    if not {k[0] for k in new if k[1] == nb} >= {"fps", "sa_select", "sa", "sa_fast"}:
        raise AssertionError(f"port bench: the sweep's B={nb} shapes {new}")
    problem = random_problem_batch(torch.Generator(dev).manual_seed(SEED + 16), nb, device=dev)
    with torch.no_grad():
        pc = assemble_point_cloud(problem.q0, problem.target_rot, problem.target_trans,
                                  problem.scene, generator=torch.Generator(dev).manual_seed(SEED))
    xyz, feat = pc[..., :3].contiguous(), pc[..., 3:].contiguous()
    summary["new_shapes"] = [time_at_shape(key, sweep[key], {}, xyz, feat, sa_w, radii, smi)
                             for key in new]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        run("--profile", ["--profile", tmp, "--repeats", "1"])
        trace = Path(tmp) / f"rollout_b{B}_{STEPS_SHORT}steps.json"
        if not trace.is_file():
            raise AssertionError(f"port bench --profile: no trace in {sorted(Path(tmp).iterdir())}")
        names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("cat") == "kernel"]
        hits = Counter(k for name in names
                       for k in ("fps_kernel", "sa_select_kernel", "sa_kernel_mma") if k in name)
        log(f"port bench --profile: {trace.name}, {trace.stat().st_size} bytes, "
            f"{len(names)} device kernel events; the port's kernels {dict(hits)}")
        if not hits["fps_kernel"]:
            raise AssertionError("port bench --profile: the trace holds no FPS kernel")
    log(json.dumps({"port_bench": summary, "card": smi}))
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mpinets_torch.kernels import ops
    except ImportError as e:
        print(f"chip_smoke: the mpinets_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    from collections import Counter

    from mpinets_torch.cli.config import load_config
    from mpinets_torch.cli.serve import Planner, serve
    from mpinets_torch.data.synthetic import (
        random_configuration,
        random_problem_batch,
        training_batch,
    )
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.model import checkpoint as ckpt
    from mpinets_torch.model import fused
    from mpinets_torch.model.fused_train import _mlp_tensors, make_fused_train_apply
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.probes import micro, scan
    from mpinets_torch.probes import session as probe_session
    from mpinets_torch.robot import franka
    from mpinets_torch.rollout.engine import make_rollout_fn
    from mpinets_torch.train import learner
    from mpinets_torch.train.trainer import Trainer
    from mpinets_torch.utils.normalization import normalize_franka_joints

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    # ---- 0. card and build ------------------------------------------------
    phase("card and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = ops.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall, per source {built}")
    resources = {}
    for name in ops.SOURCES:
        resources.update(kernel_resources((ops.BUILD_DIR / f"{name}.log").read_text()))
    for kname, res in resources.items():
        log(f"  {kname}: {res}")
    # every SA MLP (tensor-core and CUDA-core), ball-query and FPS
    # instantiation: no spill
    variants = ((0, 0, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0))
    for kname in (*(f"sa_kernel_mma<raw={r}, point0={p0}, fast={f}>" for r, p0, f in variants),
                  "sa_kernel_mma<raw=0, point0=0, fast=0, wgmma=1>",
                  *(f"sa_kernel<tr={tr}, raw={r}, point0={p0}, fast={f}>"
                    for tr in (4, 8) for r, p0, f in variants),
                  *(f"sa_select_kernel<{cpw}>" for cpw in (1, 2, 4)),
                  "sa_bwd_dw_kernel", "sa_bwd_reduce_kernel",
                  *(f"probe_scan_kernel<{m}>" for m in range(len(scan.SCAN_MODES))),
                  *micro.roll_instantiations(),
                  *(f"probe_micro_kernel<{micro.MICRO_OPS.index(o)}>" for o in ("gather", "vadd")),
                  "probe_prefix_kernel",
                  *(f"fps_kernel<{t}, {p_}, cluster={int(c)}>" for t in ("f32", "bf16")
                    for c in (False, True) for p_ in ((8,) if c else ops.FPS_POINTS_PER_THREAD))):
        res = resources.get(kname, {})
        if res.get("spill_stores", 1) or res.get("spill_loads", 1):
            raise AssertionError(f"{kname} spills (or is missing): {res}")
    # the SA backward's row kernel fills its 255 registers in the tile loop
    # and spills a few per-item scalars outside it (8-12 bytes in its SASS,
    # none inside the loop): at most SA_BWD_SPILL bytes
    res = resources.get("sa_bwd_rows_kernel", {})
    if not (res and max(res["spill_stores"], res["spill_loads"]) <= SA_BWD_SPILL):
        raise AssertionError(f"sa_bwd_rows_kernel spills more than {SA_BWD_SPILL} bytes "
                             f"(or is missing): {res}")
    # the roll's rep loop at the session's rb: one FADD a held row and one SHFL
    # a rep (a loop unrolled k times: k kC FADD and k SHFL)
    roll_plan = micro.micro_plan(probe_session.FULL["rb"], "roll_wide")
    kc = roll_plan["rows_per_thread"]
    loops = sass_loops(ops._target("probes"), rf"probe_roll_kernelILi{kc}ELb0ELb0E")
    if loops is None:
        log("cuobjdump not found: the roll's SASS check skipped")
    else:
        log(f"{roll_plan['kernel']} SASS loops (instructions, FADD, SHFL): "
            f"{[(lp['instructions'], lp['fadd'], lp['shfl']) for lp in loops]}")
        if not any(lp["shfl"] and lp["fadd"] == kc * lp["shfl"] for lp in loops):
            raise AssertionError(f"{roll_plan['kernel']}: no rep loop with {kc} FADD a SHFL: {loops}")
    # bd_matmul's rep loop: a rep is one FMUL (|acc[1]| * 0) and 49 + 48
    # FADD (the accumulators and the prefix; the 49th prefix add is dead), and
    # no f32/bf16 conversion: the values are converted once, at the load
    loops = sass_loops(ops._target("probes"), r"probe_prefix_kernel")
    if loops is not None:
        log("probe_prefix_kernel SASS loops (instructions, FADD, FMUL, F2F/F2FP): "
            f"{[(lp['instructions'], lp['fadd'], lp['fmul'], lp['f2f']) for lp in loops]}")
        per_rep = 2 * micro.GROUP - 1
        if (not any(lp["fmul"] and lp["fadd"] == per_rep * lp["fmul"] for lp in loops)
                or any(lp["f2f"] for lp in loops)):
            raise AssertionError(f"probe_prefix_kernel: no rep loop of {per_rep} FADD a FMUL "
                                 f"without conversions: {loops}")
    hmma = sass_hmma(ops._target("sa"))
    if hmma is None:
        log("cuobjdump not found: HMMA count skipped")
    else:
        log(f"(HMMA, HGMMA) instructions in the SASS of sa.cu, per kernel: {hmma}")
        # four mma.sync instantiations, and the wgmma one (template flag 4 set)
        mma_kernels = {k: v for k, v in hmma.items() if "sa_kernel_mma" in k}
        wg = {k: v for k, v in mma_kernels.items() if "Lb0ELb0ELb0ELb1E" in k}
        if (len(mma_kernels) != 5 or len(wg) != 1 or not all(v[1] for v in wg.values())
                or not all(v[0] for k, v in mma_kernels.items() if k not in wg)):
            raise AssertionError(f"sa_kernel_mma instantiations without tensor-core "
                                 f"instructions: {hmma}")
        # the SA backward's row and weight-cotangent kernels run on wgmma
        bwd = {k: v for k, v in sass_hmma(ops._target("sa_bwd")).items() if "sa_bwd_" in k}
        log(f"(HMMA, HGMMA) instructions in the SASS of sa_bwd.cu, per kernel: {bwd}")
        if not all(v[1] for k, v in bwd.items() if "rows" in k or "dw" in k) or len(bwd) != 3:
            raise AssertionError(f"sa_bwd kernels without wgmma: {bwd}")

    gen = torch.Generator().manual_seed(SEED)
    model = MotionPolicyNetwork(compute_dtype=bf16, device="cpu", generator=gen).to(dev).eval()
    sa_w = {dt: fused.sa_weights(model, dt) for dt in (f32, bf16)}
    stage_radii = [size["radius"] for size in fused.stage_sizes(model)]
    # the MLP's plan at each main-path batch: kernel, shared memory, blocks
    # per SM and centroids per block (cpb)
    for stage, (c_in, s_) in enumerate(((1, 512), (64, 128))):
        for dt in (f32, bf16):
            for variant, in_cloud, raw, fast in (("sa", True, False, False),
                                                 ("sa_raw", True, True, False),
                                                 ("sa_v3", False, False, False),
                                                 ("sa_fast", True, False, True)):
                if fast and stage:
                    continue
                plans = {b_: ops.sa_launch_plan(sa_w[dt][stage], c_in, b_, s_, in_cloud, raw,
                                                fast) for b_ in SA_MAIN_BATCHES}
                log(f"  launch plan SA{stage} {str(dt)[6:]} {variant}, by B: {plans}")
    if ops.sa_launch_plan(sa_w[bf16][0], 1, B, 512, fast=True)["cpb"] <= 8:
        raise AssertionError("the SA0 plan keeps 8 centroids a block at B=256")
    for b_ in (1, 3, 10, 64, B):
        for n_, s_ in ((6272, 512), (512, 128)):
            log(f"  launch plan sa_select B={b_} N={n_} S={s_}: {ops.sa_select_plan(b_, n_, s_)}")
    for b_, n_, s_ in ((1, 6272, 512), (3, 6272, 512), (10, 6272, 512), (64, 6272, 512),
                       (B, 6272, 512), (B, 512, 128), (4, 192, 16), (4, 16, 8)):
        plan = ops.fps_plan(b_, n_)
        log(f"  launch plan fps B={b_} N={n_} S={s_}: {plan}, "
            f"{ops.fps_plan_info(n_, s_, plan, bf16)}")
    ggen = torch.Generator(dev).manual_seed(SEED)
    problem = random_problem_batch(ggen, B, device=dev)
    with torch.no_grad():
        pc = assemble_point_cloud(problem.q0, problem.target_rot, problem.target_trans,
                                  problem.scene, generator=ggen)
    xyz = pc[..., :3].contiguous()
    feat = pc[..., 3:].contiguous()
    q_norm = normalize_franka_joints(problem.q0)

    # ---- 1. each kernel against its plain version -------------------------
    phase("FPS kernel vs plain (each main-path plan at B=1, 3 and 256; assembled and tie clouds)")
    cent = {}
    ties = torch.from_numpy(tie_cloud(np.random.default_rng(SEED), B, xyz.shape[1])).to(dev)
    for cloud_label, cloud in (("assembled", xyz), ("ties", ties)):
        for b_ in (1, 3, B):
            pts = cloud[:b_]
            for label, npoint in (("SA0", 512), ("SA1", 128)):
                ref_idx, ref_c = by_rows(lambda t: ops.fps_plain(t, npoint), pts)
                for impl in ("v1", "v2"):
                    idx, coords = ops.furthest_point_sample_with_coords(pts, npoint, impl=impl)
                    torch.cuda.synchronize()
                    if not torch.equal(idx, ref_idx) or not torch.equal(coords, ref_c):
                        bad = (idx != ref_idx).any(-1).sum().item()
                        raise AssertionError(f"FPS {cloud_label} {label} B={b_} impl={impl}: "
                                             f"{bad} rows differ from plain")
                log(f"FPS {cloud_label} [{b_},{pts.shape[1]}]->{npoint}, plan "
                    f"{tuple(ops.fps_plan(b_, pts.shape[1]))}: idx and coords equal (v1, v2)")
                if cloud_label == "assembled" and b_ < B and label == "SA0":
                    # every cluster size the kernel takes: equal to plain, and timed
                    times = {}
                    for c in ops.FPS_CLUSTERS:
                        plan = ops.fps_plan(b_, pts.shape[1], cluster=c)
                        with mock.patch.object(ops, "fps_plan", lambda *_, plan=plan: plan):
                            run = lambda: ops.furthest_point_sample_with_coords(pts, npoint)
                            if not all(map(torch.equal, run(), (ref_idx, ref_c))):
                                raise AssertionError(f"FPS B={b_} plan {plan} differs from plain")
                            times[tuple(plan)] = cuda_ms(run, 5)
                    log(f"FPS [{b_},{pts.shape[1]}]->{npoint} by plan, ms (equal to plain): "
                        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f" [{smi}]")
                if cloud_label == "assembled" and b_ == B:
                    cent[label] = coords
                pts = coords

    phase("ball-query kernel vs plain (SA0, SA1; B=256 and B=1; the count spread)")
    sgen = torch.Generator(dev).manual_seed(SEED + 6)
    spread = {stage: spread_cloud(sgen, stage_radii[stage], c_in, 4, dev, counts)
              for stage, c_in, counts in ((0, 1, SPREAD_SA0), (1, 64, SPREAD))}
    for label, xs, cs, radius in (
            ("SA0", xyz, cent["SA0"], stage_radii[0]), ("SA1", cent["SA0"], cent["SA1"],
                                                        stage_radii[1]),
            ("SA0 B=1", xyz[:1], cent["SA0"][:1], stage_radii[0]),
            ("SA1 B=1", cent["SA0"][:1], cent["SA1"][:1], stage_radii[1]),
            *((f"SA{st} count spread", spread[st][0], spread[st][2], stage_radii[st])
              for st in (0, 1))):
        idx, count = ops.sa_select(xs, cs, radius)
        torch.cuda.synchronize()
        ref_idx, ref_count = by_rows(lambda x_, c_: ops.sa_select_plain(x_, c_, radius), xs, cs)
        if not (torch.equal(idx, ref_idx) and torch.equal(count, ref_count)):
            bad = ((idx != ref_idx).any(-1) | (count != ref_count)).sum().item()
            raise AssertionError(f"sa_select {label}: {bad} centroids differ from plain")
        log(f"sa_select {label} [{xs.shape[0]},{xs.shape[1]}]->{cs.shape[1]}: idx and count "
            f"equal; kept per centroid: mean {count.float().mean().item():.2f}, "
            f"{(count == 128).float().mean().item():.3f} of centroids at 128")

    def check_sa(label, args, stage, dtype, chunks_fn=None, in_cloud=True, raw=False,
                 timed=True):
        """One SA kernel variant against its plain version: idx arrays equal,
        raw blocks bit-equal, features within the gate; timed in bf16 (the
        exact grouping also with the ball query and the MLP launched apart)."""
        radius = stage_radii[stage]
        weights = sa_w[dtype][stage]
        chunks = None if chunks_fn is None else chunks_fn(*args[::2])
        run = lambda: ops.sa_kernel(*args, weights, radius, chunks, in_cloud, raw)
        out = run()
        torch.cuda.synchronize()

        def plain(xs, fs, cs):
            ch = None if chunks_fn is None else chunks_fn(xs, cs)
            return ops.sa_plain(xs, fs, cs, weights, radius, ch, in_cloud, raw)

        ref = by_rows(plain, *args)
        if not torch.equal(out[1], ref[1]):
            bad = (out[1] != ref[1]).any(-1).sum().item()
            raise AssertionError(f"{label} {dtype}: idx differs from plain at {bad} centroids")
        if raw and not torch.equal(out[2], ref[2]):
            raise AssertionError(f"{label} {dtype}: raw block differs from plain")
        err = (out[0] - ref[0]).abs().max().item()
        tol = F32_TOL if dtype == f32 else BF16_TOL
        scale = max(1.0, ref[0].abs().max().item())
        log(f"{label} {str(dtype)[6:]}: idx equal{'; raw bit-equal' if raw else ''}; "
            f"max |feat err| {err:.3e} (tol {tol} x {scale:.2f}), "
            f"max |feat| {ref[0].abs().max().item():.3f}")
        if not err <= tol * scale:
            raise AssertionError(f"{label} {dtype}: feature error {err} > {tol * scale}")
        if dtype != bf16 or not timed:
            return out
        xs, fs, cs = args
        # the kernels alone: window and weights made outside the timed calls
        ms = cuda_ms(run, 3)
        split = ""
        if chunks is None:   # the ball query and the MLP, launched apart
            sel = ops.sa_select(xs, cs, radius)
            sel_ms = cuda_ms(lambda: ops.sa_select(xs, cs, radius), 3)
            mlp_ms = cuda_ms(lambda: ops.sa_kernel(*args, weights, radius, None, in_cloud, raw,
                                                   selection=sel), 3)
            split = f" = select {sel_ms:.4f} + MLP {mlp_ms:.4f} ms launched apart"
        log(f"{label} B={xs.shape[0]}: kernels {ms:.4f} ms{split} [{smi}]")
        return out

    fast_chunks = lambda xs, cs: ops.chunk_window(xs, cs, FAST_W)
    phase("exact SA kernel vs plain (SA0, SA1)")
    sa0_args = (xyz, feat, cent["SA0"])
    f0 = None
    for dtype in (f32, bf16):
        f0 = check_sa("sa SA0", sa0_args, 0, dtype)[0]
    sa1_args = (cent["SA0"], f0, cent["SA1"])
    for dtype in (f32, bf16):
        check_sa("sa SA1", sa1_args, 1, dtype)
    phase(f"fast SA0 kernel vs plain (W={FAST_W})")
    for dtype in (f32, bf16):
        check_sa(f"sa_fast SA0 W={FAST_W}", sa0_args, 0, dtype, chunks_fn=fast_chunks)
    phase("SA kernel raw block vs plain (SA0, SA1)")
    for dtype in (f32, bf16):
        check_sa("sa_raw SA0", sa0_args, 0, dtype, raw=True)
        check_sa("sa_raw SA1", sa1_args, 1, dtype, raw=True)
    phase("SA kernel, centroids off the cloud (v3) vs plain (SA0, SA1)")
    for label, args, stage in (("SA0", sa0_args, 0), ("SA1", sa1_args, 1)):
        off = args[2].clone()
        off[:, 1::3] += 0.013                   # beside their points
        off[:, 2::17] = torch.tensor([5.0, -4.0, 3.0], device=dev)  # no neighbour: point 0's row
        off_args = (args[0], args[1], off)
        for dtype in (f32, bf16):
            out = check_sa(f"sa_v3 {label} off-cloud", off_args, stage, dtype, in_cloud=False,
                           timed=False)
            radius = stage_radii[stage]
            v8 = ops.sa_stage(*off_args, sa_w[dtype][stage], radius, impl="v8",
                              centroids_in_cloud=True)
            v5 = ops.sa_stage(*off_args, sa_w[dtype][stage], radius, impl="v5",
                              centroids_in_cloud=True)
            if not (torch.equal(v5[0], v8[0]) and torch.equal(v5[1], v8[1])):
                raise AssertionError(f"{label} {dtype}: impl v5 differs from v8")
            if torch.equal(out[0][:, 2::17], v8[0][:, 2::17]):
                raise AssertionError(f"{label} {dtype}: the count==0 branch did not fire")
        log(f"{label}: impl v5 (centroids_in_cloud) equals v8 bit for bit")
        check_sa(f"sa_v3 {label}", args, stage, bf16, in_cloud=False)

    phase("SA kernel, neighbour counts across the 16-row tiles (SA0, SA1 widths), the wgmma "
          "kernel's 64-row tiles and work items (SA1, bf16) and the CUDA-core kernel's 64- and "
          "128-row tiles (f32); bit-equal across centroids per block")
    whole = lambda xs, cs: ops.chunk_window(xs, cs, -(-xs.shape[1] // 128))
    variants = (("sa", {}), ("sa_raw", dict(raw=True)), ("sa_v3", dict(in_cloud=False)),
                ("sa_fast", dict(chunks_fn=whole)))
    tile_spread = {stage: spread_cloud(sgen, stage_radii[stage], c_in, 4, dev, SPREAD_TILES)
                   for stage, c_in in ((0, 1), (1, 64))}
    for label, stage, counts in (("SA0", 0, SPREAD_SA0), ("SA1", 1, SPREAD)):
        for dtype in (f32, bf16):
            for kernel, kw in variants:
                check_sa(f"{kernel} {label} count spread ({len(counts)} centroids)",
                         spread[stage], stage, dtype, timed=False, **kw)
        for dtype in (f32, bf16):
            for kernel, kw in variants:
                check_sa(f"{kernel} {label} row-tile spread ({len(SPREAD_TILES)} centroids)",
                         tile_spread[stage], stage, dtype, timed=False, **kw)

    def cpb_equal(label, args, stage, variants, cpbs, timed, dtype=bf16):
        """The MLP kernel of ``dtype`` (bf16: tensor cores; f32: CUDA cores)
        under each of cpbs (centroids per block): idx, raw block and features
        bit-equal to cpb 8's; on the exact path the MLP alone, reading one
        selection; timed where asked."""
        w, radius = sa_w[dtype][stage], stage_radii[stage]
        for kernel, kw in variants:
            chunks = kw["chunks_fn"](args[0], args[2]) if "chunks_fn" in kw else None
            sel = None if chunks is not None else ops.sa_select(args[0], args[2], radius)
            in_cloud, raw = kw.get("in_cloud", True), kw.get("raw", False)
            outs, times = {}, {}
            for cpb in cpbs:
                run = lambda cpb=cpb: ops.sa_kernel(*args, w, radius, chunks, in_cloud, raw,
                                                    selection=sel, centroids_per_block=cpb)
                outs[cpb] = run()
                if timed:
                    times[cpb] = cuda_ms(run, 3)
            torch.cuda.synchronize()
            for cpb, out in outs.items():
                if not all(map(torch.equal, out, outs[8])):
                    raise AssertionError(f"{kernel} {label} {dtype}: cpb {cpb} differs from cpb 8")
            auto = ops.sa_launch_plan(w, args[1].shape[-1], args[0].shape[0], args[2].shape[1],
                                      in_cloud, raw, chunks is not None)["cpb"]
            log(f"{kernel} {label} {str(dtype)[6:]}: idx{', raw' if raw else ''} and features "
                f"bit-equal under cpb {list(cpbs)} (the plan's: {auto})"
                + (": MLP ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                   + f" [{smi}]" if timed else ""))

    # SA1's weights and tiles leave no room for 32 centroids a block, on
    # either kernel
    for label, stage, cpbs in (("SA0", 0, (8, 16, 32)), ("SA1", 1, (8, 16))):
        cpb_equal(f"{label} count spread", spread[stage], stage, variants, cpbs, False)
        cpb_equal(f"{label} row-tile spread", tile_spread[stage], stage, variants, cpbs, False,
                  f32)
    # the wgmma kernel (SA1's exact stage) in work items of 8 and 16 centroids
    cpb_equal("SA1 row-tile spread", tile_spread[1], 1, (("sa", {}),), (8, 16), False)
    cpb_equal(f"SA0 B={B} assembled cloud", sa0_args, 0,
              (("sa", {}), ("sa_fast", dict(chunks_fn=fast_chunks))), (8, 16, 32), True)
    for dtype in (f32, bf16):
        cpb_equal("SA1 B=32 assembled cloud", tuple(t[:32] for t in sa1_args), 1, (("sa", {}),),
                  (8, 16), True, dtype)
    cpb_equal(f"SA0 B={B} assembled cloud", sa0_args, 0, (("sa", {}),), (8, 16, 32), True, f32)

    phase("bf16 beyond the tensor cores' shared memory (C1 = C2 = 512): the CUDA-core kernel")
    wgen = torch.Generator(dev).manual_seed(SEED + 8)
    dims = (67, 512, 512, 64)
    wide = ops.prepare_sa_weights(*(t for i in range(3) for t in (
        0.1 * torch.randn(dims[i], dims[i + 1], generator=wgen, device=dev),
        0.1 * torch.randn(dims[i + 1], generator=wgen, device=dev))), compute_dtype=bf16)
    plan = ops.sa_launch_plan(wide, 64, 4, len(SPREAD))
    if plan["mma"]:
        raise AssertionError(f"C1 = C2 = 512 in bf16 took the tensor-core kernel: {plan}")
    out = ops.sa_kernel(*spread[1], wide, stage_radii[1])
    torch.cuda.synchronize()
    ref = by_rows(lambda x_, f_, c_: ops.sa_plain(x_, f_, c_, wide, stage_radii[1]), *spread[1])
    err = (out[0] - ref[0]).abs().max().item()
    scale = max(1.0, ref[0].abs().max().item())
    if not (torch.equal(out[1], ref[1]) and err <= BF16_TOL * scale):
        raise AssertionError(f"bf16 CUDA-core kernel: idx equal {torch.equal(out[1], ref[1])}, "
                             f"feature error {err} > {BF16_TOL * scale}")
    log(f"bf16 CUDA-core kernel, plan {plan}: idx equal, max |feat err| {err:.3e} "
        f"(tol {BF16_TOL} x {scale:.2f})")

    # ---- 2. full-width forward: kernel path against the plain paths -------
    phase(f"full-width forward, B={B}")

    model32 = MotionPolicyNetwork(compute_dtype=f32, device="cpu")
    model32.load_state_dict(model.state_dict())
    model32.to(dev).eval()
    with torch.no_grad():
        oracle = by_rows(model32, pc, q_norm)
    kern32 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=f32)
    err = (kern32 - oracle).abs().max().item()
    log(f"f32 kernel path vs plain policy (pointnet oracle): max |dq err| {err:.3e}, "
        f"max |dq| {oracle.abs().max().item():.3f}")
    if not err <= FWD_F32_TOL:
        raise AssertionError(f"f32 forward error {err} > {FWD_F32_TOL}")
    for fast, bf16_cloud in ((0, False), (FAST_W, False), (0, True)):
        kern = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16,
                                        fast_grouping=fast, bf16_cloud=bf16_cloud)
        ref = plain_policy_path(model, pc, q_norm, bf16, fast, bf16_cloud)
        if not torch.isfinite(kern).all() or kern.shape != (B, 7):
            raise AssertionError(f"bf16 forward: bad output shape/values {kern.shape}")
        err = (kern - ref).abs().max().item()
        scale = ref.abs().max().item()
        log(f"bf16 kernel path vs plain path, fast_grouping={fast}, bf16_cloud={bf16_cloud}: "
            f"max |dq err| {err:.3e}, max |dq| {scale:.3f}")
        if not err <= FWD_BF16_TOL * max(scale, 1e-3):
            raise AssertionError(f"bf16 forward (W={fast}, bf16_cloud={bf16_cloud}) error "
                                 f"{err} > tol")
    # v3 and v8 compute one function on FPS centroids (no centroid without
    # neighbours), but SA1's v8 stage runs the wgmma kernel and v3's the
    # mma.sync one, whose sums round apart: within the bf16 forward's gate
    kern_v3 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16, sa_impl="v3")
    kern_v8 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16)
    err = (kern_v3 - kern_v8).abs().max().item()
    scale = kern_v8.abs().max().item()
    if not err <= FWD_BF16_TOL * max(scale, 1e-3):
        raise AssertionError(f"bf16 forward: sa_impl v3 differs from v8 on FPS centroids by {err}")
    log(f"bf16 kernel path, sa_impl v3 against v8 on FPS centroids: max |dq gap| {err:.3e}, "
        f"max |dq| {scale:.3f}")
    torch.cuda.synchronize()

    phase(f"fused train step: kernels vs plain, B={GRAD_B}, full widths; the SA backward "
          f"kernels at B={SA_BWD_BATCHES}: vs plain, times, bounds and the replay they replaced")
    tb = training_batch(torch.Generator(dev).manual_seed(SEED + 3), GRAD_B, device=dev)

    def train_grads(cdt, sa_impl="v8"):
        apply = make_fused_train_apply(cdt, sa_impl=sa_impl)
        model.zero_grad(set_to_none=True)
        total, _ = learner.loss_fn(model, tb, apply_fn=apply)
        total.backward()
        return total.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    for sa_impl in ("v8", "v3"):
        grads = {}
        for cdt in (f32, bf16):
            grads[cdt, "kernel"] = train_grads(cdt, sa_impl)
            with plain_ops(ops):
                grads[cdt, "plain"] = train_grads(cdt, sa_impl)
        worst = max((grads[f32, "kernel"][1][k] - g).abs().max().item()
                    / (GRAD_ATOL + GRAD_RTOL * g.abs().max().item())
                    for k, g in grads[f32, "plain"][1].items())
        # per tensor: rel L2 kernel-plain (bf16) over its gate, sqrt(2) x the
        # larger of the tensor's and the whole policy's bf16-to-f32 distance
        g_bf16, g_f32 = grads[bf16, "plain"][1], grads[f32, "plain"][1]
        whole = rel_l2(torch.cat([g.flatten() for g in g_bf16.values()]),
                       torch.cat([g_f32[k].flatten() for k in g_bf16]))
        ratios = []
        for k, g in g_bf16.items():
            d = rel_l2(grads[bf16, "kernel"][1][k], g)
            gate = BF16_GRAD_FACTOR * max(rel_l2(g, g_f32[k]), whole)
            ratios.append((d / gate, k, d, gate))
        ratios.sort(reverse=True)
        sa_worst = next(r for r in ratios if ".sa0." in r[1] or ".sa1." in r[1])
        log(f"sa_impl {sa_impl}: loss f32 kernel {grads[f32, 'kernel'][0]:.6f} plain "
            f"{grads[f32, 'plain'][0]:.6f}, bf16 kernel {grads[bf16, 'kernel'][0]:.6f} plain "
            f"{grads[bf16, 'plain'][0]:.6f}; f32 grads worst |err| / (atol + rtol max|g|) "
            f"{worst:.3f}; bf16 grads rel L2 bf16-f32 (plain, whole policy) {whole:.3e}; "
            f"kernel-plain per tensor {min(r[2] for r in ratios):.3e} to "
            f"{max(r[2] for r in ratios):.3e}; over its gate, worst: "
            + "; ".join(f"{k} {d:.3e}/{gate:.3e} = {r:.3f}"
                        for r, k, d, gate in ratios[:3] + [sa_worst]))
        if not worst <= 1.0:
            raise AssertionError(f"train gradients f32 ({sa_impl}): kernel vs plain {worst} > 1")
        if not ratios[0][0] <= 1.0:
            raise AssertionError(f"train gradients bf16 ({sa_impl}): {ratios[0][1]} rel L2 "
                                 f"{ratios[0][2]} > {ratios[0][3]}")
    model.zero_grad(set_to_none=True)
    bwd_gen = torch.Generator().manual_seed(SEED + 5)
    for b_ in SA_BWD_BATCHES:
        sa_backward_rows(model, training_batch(torch.Generator(dev).manual_seed(SEED + 4), b_,
                                               device=dev), smi, bwd_gen)

    # ---- 3+4. the main paths: server, batched rollout, v3 rollout, trainer -
    main_launches = Counter()

    def count_path(name, kernels):
        """Read the counts of the path just driven, check that each of its
        kernels ran, and add them to the main-path totals."""
        run = dict(ops.LAUNCHES_BY_SHAPE)
        main_launches.update(run)
        per_kernel = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"{name}: launches {per_kernel}; FPS by plan "
            f"{ {tuple(plan): v for plan, v in ops.FPS_LAUNCHES_BY_PLAN.items()} }")
        for k in kernels:
            if not ops.LAUNCHES[k]:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        return run

    ops.reset_launches()
    phase("planning server: 3 requests on the exact path")
    rng = np.random.default_rng(SEED)
    planner = Planner(model, tabletop_scan(rng), device=dev)
    requests = []
    for _ in range(3):
        q0 = random_configuration(ggen, (), dev)
        pos, quat = kinematics.eff_pose_quat(random_configuration(ggen, (), dev))
        requests.append(json.dumps({"q0": q0.tolist(), "target_position": pos.tolist(),
                                    "target_quaternion": quat.tolist()}))
    out = io.StringIO()
    t0 = time.perf_counter()
    serve(planner, io.StringIO("\n".join(requests) + "\n"), out)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    lo, hi = franka.JOINT_LIMITS[:, 0] - 1e-4, franka.JOINT_LIMITS[:, 1] + 1e-4
    for line in out.getvalue().splitlines():
        resp = json.loads(line)
        if set(resp) != {"success", "num_steps", "trajectory", "times"}:
            raise AssertionError(f"server response keys {sorted(resp)}")
        traj = np.asarray(resp["trajectory"])
        if traj.shape != (resp["num_steps"] + 1, 7) or len(resp["times"]) != len(traj):
            raise AssertionError(f"server trajectory shape {traj.shape}")
        if not (np.isfinite(traj).all() and (traj >= lo).all() and (traj <= hi).all()):
            raise AssertionError("server trajectory leaves the joint limits")
        log(f"response: success={resp['success']} num_steps={resp['num_steps']}")
    log(f"server: 3 requests in {t_serve:.2f} s")
    count_path("server", ("fps", "sa_select", "sa"))

    phase(f"batched rollout: B={B}, fast_grouping={FAST_W}, {STEPS_LONG} - {STEPS_SHORT} steps")
    apply_fn = fused.make_fused_apply(bf16, fast_grouping=FAST_W)
    rollouts = {
        n: make_rollout_fn(model, max_steps=n, stop_on_success=False,
                           record_trajectory=False, apply_fn=apply_fn, device=dev)
        for n in (STEPS_SHORT, STEPS_LONG)
    }

    def timed(n):
        t0 = time.perf_counter()
        res = rollouts[n](problem, torch.Generator(dev).manual_seed(SEED + 1))
        final = res.final_q.cpu()
        return time.perf_counter() - t0, final

    ops.reset_launches()
    t_long, final = timed(STEPS_LONG)
    per_step = {f"{k} B={b_} N={n} S={s_}": v / STEPS_LONG
                for (k, b_, n, s_), v in ops.LAUNCHES_BY_SHAPE.items()}
    if not torch.isfinite(final).all():
        raise AssertionError("rollout: non-finite configurations")
    rates = []
    for _ in range(3):
        t_short, _ = timed(STEPS_SHORT)
        t_long, _ = timed(STEPS_LONG)
        rates.append(B * (STEPS_LONG - STEPS_SHORT) / (t_long - t_short))
    rate = float(np.median(rates))
    log(f"rollout: env-steps/s {rates} (median {rate:.1f}); launches per step {per_step}")
    count_path("rollouts", ("fps", "sa_select", "sa", "sa_fast"))

    phase(f"profile: one {STEPS_SHORT}-step rollout (torch.profiler)")
    profile_rollout(rollouts[STEPS_SHORT], problem, torch.Generator(dev).manual_seed(SEED + 2))

    phase(f"rollout through the v3 stage: B={B}, {V3_STEPS} steps, exact grouping")
    finals = {}
    for sa_impl in ("v8", "v3"):
        rollout = make_rollout_fn(model, max_steps=V3_STEPS, stop_on_success=False,
                                  record_trajectory=False, device=dev,
                                  apply_fn=fused.make_fused_apply(bf16, sa_impl=sa_impl))
        if sa_impl == "v3":
            ops.reset_launches()
        finals[sa_impl] = rollout(problem, torch.Generator(dev).manual_seed(SEED + 4)).final_q
        if sa_impl == "v3":
            torch.cuda.synchronize()
            count_path("v3 rollout", ("fps", "sa_select", "sa_v3"))
    # each step's v3 policy is within the bf16 forward's gate of v8's (above),
    # so the final configurations within that share of the motion, a step each
    gap = (finals["v3"] - finals["v8"]).abs().max().item()
    motion = (finals["v8"] - problem.q0).abs().max().item()
    if not gap <= FWD_BF16_TOL * V3_STEPS * motion:
        raise AssertionError(f"v3 rollout differs from the v8 rollout on FPS centroids by {gap} "
                             f"(motion {motion})")
    log(f"v3 rollout: final configurations within {gap:.3e} of the v8 rollout's "
        f"(max motion {motion:.3e})")

    phase(f"trainer: synthetic data, reference widths, bf16, B={TRAIN_BATCHES}")
    train_rates = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for tb_size in TRAIN_BATCHES:
            cfg = load_config(None, {"optim": {"batch_size": tb_size, "bf16": True},
                                     "save_checkpoint_dir": tmp, "seed": SEED})
            cfg.data.synthetic = True
            ops.reset_launches()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, test=True, device="cuda")
            state = trainer.run()
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            count_path(f"trainer B={tb_size}", ("fps", "sa_select", "sa_raw", "sa", "sa_bwd"))
            rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
            val = [r for r in rows if "avg_target_error" in r]
            losses = [r["val_loss"] for r in rows if "val_loss" in r]
            if state.step != 10 or len(val) != 5 or not all(
                    np.isfinite(v) for r in rows for v in r.values()):
                raise AssertionError(f"trainer B={tb_size}: step {state.step}, rows {rows}")
            log(f"trainer B={tb_size}: 10 steps + 5 validations in {t_run:.1f} s; "
                f"loss {losses}; last validation {val[-1]}")
            # checkpoint round trip: the last checkpoint restores the state exactly
            fresh = learner.init_state(MotionPolicyNetwork(
                compute_dtype=bf16, device=dev, generator=torch.Generator().manual_seed(9)))
            restored = ckpt.restore_checkpoint(ckpt.latest_checkpoint(trainer.ckpt_dir), fresh)
            same = all(torch.equal(a, b) for a, b in zip(restored.model.state_dict().values(),
                                                         state.model.state_dict().values()))
            if not (same and restored.step == 10
                    and restored.optimizer.param_groups[0]["count"] == 10):
                raise AssertionError(f"trainer B={tb_size}: checkpoint restore differs")
            log(f"trainer B={tb_size}: checkpoint {ckpt.latest_checkpoint(trainer.ckpt_dir).name}"
                f" restores step {restored.step} bit for bit")

            # timed steps of the trainer's own step function: one batch
            # reused, then a fresh batch made before each step
            step_fn = learner.make_train_step(apply_fn=make_fused_train_apply(bf16))
            gen = torch.Generator(dev).manual_seed(SEED + 5)
            batch = training_batch(gen, tb_size, device=dev)
            holder = [step_fn(state, batch)[0]]
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)

            def step(make=None):
                holder[0], _ = step_fn(holder[0], batch if make is None else make())

            times = step_times(step, TRAIN_MIN_S, TRAIN_CHUNK)
            per_step = {k: (v - before[k]) / (len(times) * TRAIN_CHUNK)
                        for k, v in ops.LAUNCHES.items() if v - before[k]}
            data_times = step_times(
                lambda: step(lambda: training_batch(gen, tb_size, device=dev)),
                TRAIN_MIN_S, TRAIN_CHUNK)
            state = holder[0]
            tr = {}
            for key, ts in (("", times), ("with_data_", data_times)):
                samples = sorted(tb_size / t for t in ts)
                tr.update({
                    f"{key}samples_per_s_median": float(np.median(samples)),
                    f"{key}samples_per_s_min": samples[0],
                    f"{key}samples_per_s_max": samples[-1],
                    f"{key}steps_per_s_median": float(np.median(samples)) / tb_size,
                    f"{key}timed_steps": len(ts) * TRAIN_CHUNK,
                    f"{key}timed_s": sum(ts) * TRAIN_CHUNK,
                })
            train_rates[tb_size] = tr
            log(f"train step B={tb_size}: {tr['timed_steps']} steps in "
                f"{tr['timed_s']:.2f} s, chunks of {TRAIN_CHUNK}: samples/s median "
                f"{tr['samples_per_s_median']:.1f} (min {tr['samples_per_s_min']:.1f}, "
                f"max {tr['samples_per_s_max']:.1f}), steps/s median "
                f"{tr['steps_per_s_median']:.2f}; with batch generation "
                f"{tr['with_data_timed_steps']} steps in {tr['with_data_timed_s']:.2f} s:"
                f" samples/s median {tr['with_data_samples_per_s_median']:.1f} (min "
                f"{tr['with_data_samples_per_s_min']:.1f}, max "
                f"{tr['with_data_samples_per_s_max']:.1f}) [{smi}]; "
                f"kernel launches per train step {per_step}")
            phase(f"profile: train step by layer, B={tb_size} (torch.profiler)")
            profile_train_layers(state, make_fused_train_apply(bf16),
                                 lambda: training_batch(gen, tb_size, device=dev))
            if tb_size == TRAIN_BATCHES[-1]:
                phase(f"profile: 3 train steps, B={tb_size} (torch.profiler)")
                profile_rollout(lambda *_: [step_fn(state, batch) for _ in range(3)], None, None)

        phase("trainer: a small cloud (64 + 96 + 32 points, SA 16/8) runs the kernels too")
        cfg = load_config(None, {
            "data": {"num_robot_points": 64, "num_obstacle_points": 96, "num_target_points": 32},
            "model": {"sa_npoints": [16, 8]}, "rollout": {"val_rollout_length": 3},
            "optim": {"batch_size": 4, "bf16": True}, "save_checkpoint_dir": tmp, "seed": SEED})
        cfg.data.synthetic = True
        ops.reset_launches()
        small = Trainer(cfg, test=True, device="cuda").run()
        torch.cuda.synchronize()
        count_path("trainer, small cloud", ("fps", "sa_select", "sa_raw", "sa", "sa_bwd"))
        if small.step != 10 or not all(torch.isfinite(p).all() for p in small.model.parameters()):
            raise AssertionError(f"trainer, small cloud: step {small.step} or non-finite weights")
    # ---- 4b. the evaluation path: cli.infer --------------------------------
    phase("evaluation: cli.infer on the card, full widths (bf16 exact, --fp32, fast, depth, "
          "batch-1 timing)")
    eval_summary = run_evaluation(model, smi, count_path)

    phase("real weights on the card: the committed checkpoint through load_params, the "
          "forward, cli.serve, cli.infer (bf16 exact, --fp32) and eval.compare")
    t0 = time.perf_counter()
    real_summary = run_real_weights(smi, dev, count_path)
    log(f"real weights: the phase took {time.perf_counter() - t0:.1f} s")
    phase("evaluation extras: calibration (bank; hull on a synthetic mesh) card vs CPU, "
          "gen --visualize-scene")
    ops.reset_launches()
    t0 = time.perf_counter()
    extras_summary = run_eval_extras(smi, dev)
    log(f"evaluation extras: hand-written kernel launches {dict(ops.LAUNCHES_BY_SHAPE)} "
        f"(plain torch: FK, the SDFs, cuBLAS); the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 4c. scene generation: the IK and the environments -----------------
    phase("scene generation: IK and environments on the card (tabletop, cubby, merged-cubby, "
          "dresser)")
    ops.reset_launches()
    t0 = time.perf_counter()
    scene_summary = run_scene_generation(smi)
    torch.cuda.synchronize()
    log(f"scene generation: hand-written kernel launches {dict(ops.LAUNCHES_BY_SHAPE)} (the "
        f"IK and the environments run none: plain torch, cuSOLVER and cuBLAS); the phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 4d. the expert pipeline and the DAgger actors --------------------
    phase("expert pipeline: plan_scene at gen's defaults in each environment, the PRM at full "
          "size, card vs CPU, gen")
    ops.reset_launches()
    t0 = time.perf_counter()
    expert_summary, planned = run_expert_pipeline(smi, dev)
    torch.cuda.synchronize()
    log(f"expert pipeline: hand-written kernel launches {dict(ops.LAUNCHES_BY_SHAPE)} (the "
        f"planner runs none: plain torch and cuBLAS); the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    phase("DAgger actors: the trainer's actor mode (synthetic) and the real collector")
    t0 = time.perf_counter()
    expert_summary["dagger"] = run_dagger(smi, dev, planned, count_path)
    log(f"DAgger actors: the phase took {time.perf_counter() - t0:.1f} s")
    phase("data-parallel training on the dataset layout (world size 1, NCCL)")
    t0 = time.perf_counter()
    dp_summary = run_data_parallel(smi, dev, planned, count_path)
    log(f"data-parallel training: the phase took {time.perf_counter() - t0:.1f} s")

    # ---- 5. the TPU probe session ----------------------------------------
    phase("TPU probes: kernels vs plain, and their times (probes.session, full shape)")
    t0 = time.perf_counter()
    ops.reset_launches()
    records = probe_session.run(dev, seed=SEED)   # raises if a kernel differs from plain
    torch.cuda.synchronize()
    parity = {r["name"]: r for r in records if r["kind"] == "parity"}
    probe_times = [r for r in records if r["kind"] == "time" and r["kernel"] in PROBE_KERNELS]
    # the timed runs are the path; the launches of the parity checks do not count
    timed_launches = Counter()
    for r in probe_times:
        timed_launches[r["kernel"]] += r["launches"]
    log(f"TPU probe session: launches in the timed runs {dict(timed_launches)}")
    for k in PROBE_KERNELS:
        if not timed_launches[k]:
            raise AssertionError(f"TPU probe session: kernel {k} was not launched")
    # the launch floor: an empty kernel in the same loop, above 0 and below
    # every probe's time
    floor = next(r for r in records if r["kind"] == "device")["launch_floor_ms"]
    log(f"launch floor (probe_empty_kernel <<<1, 32>>>, the probes' loop): {floor:.5f} ms [{smi}]")
    if not 0 < floor < min(r["ms"] for r in probe_times):
        raise AssertionError(f"launch floor {floor} ms not above 0 and below every probe's time: "
                             f"{ {r['name']: r['ms'] for r in probe_times} }")
    sa0_exact = next(r for r in records if r["kind"] == "time" and r["kernel"] == "sa")
    stages = {r["name"]: r["ms"] for r in probe_times if r["kernel"] == "probe_scan"}
    log(f"SA0 scan stages at B=256, N=6272, S=512, r=0.05 (ms): {stages}; SA0 exact (v8, bf16) "
        f"{sa0_exact['ms']:.4f} ms [{smi}]; the phase took {time.perf_counter() - t0:.1f} s")
    # the scan kernel by mode: its bound (the non-FMA f32 rate), the share of
    # it reached, and each instantiation's registers, spills and blocks a SM
    # at the session's cloud, all of this run; the log also prints the
    # recorded time before the redesign
    scan_info = {}
    for i, mode in enumerate(scan.SCAN_MODES):
        r = next(r for r in probe_times if r["name"] == f"scan_{mode}")
        res = resources.get(f"probe_scan_kernel<{i}>", {})
        plan = scan.scan_plan(probe_session.FULL["n"], mode)
        scan_info[r["name"]] = info = {
            "bound_share": r["bound_ms"] / r["ms"],
            "registers": res.get("registers"),
            "spills": res.get("spill_stores", 0) + res.get("spill_loads", 0),
            "blocks_per_sm": plan["blocks_per_sm"], "smem_bytes": plan["smem_bytes"]}
        log(f"  scan {mode}: {r['ms']:.4f} ms (recorded before the redesign: "
            f"{SCAN_WAS_MS[mode]:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {100 * info['bound_share']:.1f}% of it; "
            f"probe_scan_kernel<{i}>: {info['registers']} registers, {info['spills']} spill "
            f"bytes, {info['blocks_per_sm']} blocks a SM at {info['smem_bytes']} B [{smi}]")

    # the micro ops: each time beside its bound (the non-FMA rate; gather's
    # shared-memory words), the share reached, and the kernel's registers,
    # spills and blocks a SM at the session's rb, all of this run
    micro_info = {}
    for op in micro.MICRO_OPS:
        plan = micro.micro_plan(probe_session.FULL["rb"], op)
        res = resources.get(plan["kernel"], {})
        for r in (r for r in probe_times if r["name"].startswith(f"micro_{op}_r")):
            micro_info[r["name"]] = info = {
                "bound_share": r["bound_ms"] / r["ms"], "registers": res.get("registers"),
                "spills": res.get("spill_stores", 0) + res.get("spill_loads", 0)}
            log(f"  {r['name']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{100 * info['bound_share']:.1f}% of it; {plan['kernel']}: {info['registers']} "
                f"registers, {info['spills']} spill bytes, {plan['blocks_per_sm']} blocks a SM of "
                f"{plan['threads']} threads at {plan['smem_bytes']} B [{smi}]")
    log(f"  beside the launch floor {floor:.5f} ms: "
        + ", ".join(f"{r['name']} {r['ms']:.5f} ms ({r['ms'] / floor:.2f}x)" for r in probe_times
                    if r["name"].startswith("micro_roll_narrow_r")
                    or r["kernel"] == "probe_scratch") + f" [{smi}]")
    probe_rank = Counter()
    for r in probe_times:
        probe_rank[r["kernel"]] += r["launches"] * (r["ms"] - r["bound_ms"])
    log("probe session: launches x (ms - bound ms, the launch floor included): "
        + "; ".join(f"{k} {v:.1f}" for k, v in probe_rank.most_common()) + f" [{smi}]")

    # ---- 6. each kernel at each shape the main paths launched it at --------
    phase("kernels at the main paths' shapes: vs plain, times and bounds (bf16; _f32: f32)")
    by_shape = dict(main_launches)
    log(f"main-path launches by (kernel, B, N, S): {by_shape}")
    inputs = {}
    kernels = [time_at_shape(key, launches, inputs, xyz, feat, sa_w, stage_radii, smi)
               for key, launches in sorted(by_shape.items()) if key[0] != "sa_bwd"]
    enc = model.point_cloud_encoder
    mlps = [[t.detach() for t in _mlp_tensors(sa)] for sa in (enc.sa0, enc.sa1)]
    kernels += [sa_backward_at_shape(key, launches, inputs, xyz, feat, sa_w, mlps, stage_radii,
                                     smi, bwd_gen)
                for key, launches in sorted(by_shape.items()) if key[0] == "sa_bwd"]
    rank = Counter()
    for r in kernels:
        rank[r["name"].split()[0]] += r["launches"] * (r["ms"] - r["bound_ms"])
    log("launches x (ms - bound ms), summed over each kernel's shapes: "
        + "; ".join(f"{k} {v:.1f}" for k, v in rank.most_common()) + f" [{smi}]")

    phase("sa_f32 (the CUDA-core MLP) at B=1, 3, 32 and 256: vs plain, bound, and three cuBLAS "
          "f32 products over the same packed rows (TF32 off); its fast SA0 and v3 at B=32, 256")
    for b_ in (1, 3, 32, B):
        for stage, (n_, s_) in enumerate(((6272, 512), (512, 128))):
            key = ("sa_f32", b_, n_, s_)
            time_at_shape(key, main_launches.get(key, 0), inputs, xyz, feat, sa_w, stage_radii, smi)
            _, fs, _, sel = stage_inputs(inputs, b_, CLOUDS[0], xyz, feat, sa_w[bf16],
                                         stage_radii)[stage]
            w = sa_w[f32][stage]
            packed = int(sel[1].clamp(min=1).sum())
            x = torch.rand(packed, 3 + fs.shape[-1], device=dev)
            mats = (w.w1[: 3 + fs.shape[-1]], w.w2, w.w3)
            cublas = cuda_ms(lambda: x @ mats[0] @ mats[1] @ mats[2], 5)
            log(f"  cuBLAS, three f32 products over the {packed} packed rows of sa_f32 B={b_} "
                f"N={n_} S={s_}: {cublas:.4f} ms [{smi}]")
    # its fast SA0 and off-cloud (v3) variants, which PERF.md's table lists
    for b_ in (32, B):
        for key in (("sa_fast_f32", b_, 6272, 512), ("sa_v3_f32", b_, 6272, 512),
                    ("sa_v3_f32", b_, 512, 128)):
            time_at_shape(key, main_launches.get(key, 0), inputs, xyz, feat, sa_w, stage_radii, smi)

    phase("port bench: python -m mpinets_torch.bench in-process (defaults, --fast-grouping 0, "
          "--sa-impl v3, --sweep, --profile); the sweep's new shapes vs plain")
    t0 = time.perf_counter()
    bench_summary = run_port_bench(smi, dev, main_launches, sa_w, stage_radii)
    log(f"port bench: the phase took {time.perf_counter() - t0:.1f} s")

    for r in probe_times:
        if not r["launches"]:
            raise AssertionError(f"probe {r['name']} was not launched in the probe session")
        kernels.append({
            "name": f"{r['kernel']} {r['name']}", "route": "cuda",
            "source": CUDA_SOURCES[r["kernel"]],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": parity[r["name"]]["max_abs_err"], "ms": r["ms"],
            "plain_ms": parity[r["name"]]["plain_ms"], "bound_ms": r["work_bound_ms"],
            "bound_by": r["work_bound_by"], "library_ms": r["library_ms"],
            "launch_floor_ms": floor,
            "stands_for": r["stands_for"], **scan_info.get(r["name"], {}),
            **micro_info.get(r["name"], {}),
        })
    log(json.dumps({"env_steps_per_s_median": rate, "env_steps_per_s": rates, "batch": B,
                    "fast_grouping": FAST_W, "compute_dtype": "bfloat16",
                    "train": {str(k): v for k, v in train_rates.items()},
                    "evaluation": eval_summary, "scene_generation": scene_summary,
                    "expert_pipeline": expert_summary, "data_parallel": dp_summary,
                    "real_weights": real_summary, "evaluation_extras": extras_summary,
                    "port_bench": {k: v for k, v in bench_summary.items() if k != "new_shapes"},
                    "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
