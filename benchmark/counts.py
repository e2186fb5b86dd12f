"""The yardstick's arithmetic: the card's published peaks, a kernel's bound,
and the operations and bytes of the policy's stages.

Frozen copies: the peaks of ``mpinets_torch/probes/session.py`` (HBM, f32
CUDA cores, the non-FMA f32 rate) and ``chip_smoke.py`` (bf16 tensor
cores), and ``chip_smoke.py::bound`` with the byte and operation counts of
its ``time_at_shape`` and ``sa_data_ops``: inputs and outputs once; the
ball query's distance tests up to the 128th hit, 9 uncontracted f32
operations each; FPS 9 a point a pick; the MLP over each centroid's
max(count, 1) rows, never the 128 padded slots. The counts come from the
benchmark's plain reference, so a kernel's bound reads the same work
whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                    # f32 on the CUDA cores (an FMA is two)
BF16_FLOPS = 989e12                  # bf16 tensor cores, dense
F32_NOFMA_OPS = 132 * 128 * 1.98e9   # 132 SMs x 128 lanes x 1.98 GHz, one op a lane
PEAK = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
DIST_OPS = 9.0                       # sub, mul (x3), add (x2) and compare, no FMA


def bound_s(nbytes, dist_ops=0.0, mlp_flops=0.0, mlp_peak=BF16_FLOPS):
    """Seconds the card needs at least: bytes over the memory rate, or the
    distance operations at the non-FMA rate plus the MLP at ``mlp_peak``,
    whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, dist_ops / F32_NOFMA_OPS + mlp_flops / mlp_peak)


def mlp_flops_per_row(in_width, widths):
    """FLOP (a multiply-add is two) of one row through a ReLU MLP."""
    total, k = 0, in_width
    for w in widths:
        total += 2 * k * w
        k = w
    return total


def stage_widths(cfg):
    """(SA0 input width, SA1 input width, global SA input width)."""
    return 3 + 1, 3 + cfg["sa0"]["mlp"][-1], 3 + cfg["sa1"]["mlp"][-1]


def dense_flops_per_env(cfg):
    """FLOP a problem a step outside the two SA stages: the global SA over
    the SA1 centroids, the FC head, the configuration encoder and the
    decoder."""
    _, _, g_in = stage_widths(cfg)
    total = cfg["sa1"]["npoint"] * mlp_flops_per_row(g_in, cfg["sa2"]["mlp"])
    total += mlp_flops_per_row(cfg["sa2"]["mlp"][-1], cfg["fc"])
    total += mlp_flops_per_row(cfg["dof"], cfg["q_encoder"])
    total += mlp_flops_per_row(cfg["fc"][-1] + cfg["q_encoder"][-1], cfg["decoder"])
    return total


def padded_macs_per_env(cfg):
    """Multiply-adds a problem a step with every group padded to ``nsample``
    rows: {"sa0", "sa1", "global", "rest"} (the padded count the kernels'
    bounds must not use)."""
    s0_in, s1_in, g_in = stage_widths(cfg)
    sa0, sa1 = cfg["sa0"], cfg["sa1"]
    return {
        "sa0": sa0["npoint"] * sa0["nsample"] * mlp_flops_per_row(s0_in, sa0["mlp"]) // 2,
        "sa1": sa1["npoint"] * sa1["nsample"] * mlp_flops_per_row(s1_in, sa1["mlp"]) // 2,
        "global": sa1["npoint"] * mlp_flops_per_row(g_in, cfg["sa2"]["mlp"]) // 2,
        "rest": (dense_flops_per_env(cfg)
                 - sa1["npoint"] * mlp_flops_per_row(g_in, cfg["sa2"]["mlp"])) // 2,
    }


def stage_params(cfg, stage):
    """Parameters of one SA stage's MLP (weights and biases)."""
    k = stage_widths(cfg)[0 if stage == "sa0" else 1]
    total = 0
    for w in cfg[stage]["mlp"]:
        total += k * w + w
        k = w
    return total


def step_work(cfg, batch, count0, tests0, count1, tests1):
    """The work of one policy step over a batch, from the reference's ball
    query on that step's cloud (``count*``: points inside each centroid's
    ball; ``tests*``: its distance tests to the 128th hit; tensors over the
    batch and the centroids). -> {kernel: [(bytes, distance operations, MLP
    FLOP) of each launch]} and "model_flops", the whole policy's FLOP."""
    n = sum(cfg["points"].values())
    s0, s1 = cfg["sa0"]["npoint"], cfg["sa1"]["npoint"]
    ns0, ns1 = cfg["sa0"]["nsample"], cfg["sa1"]["nsample"]
    c0, c1 = cfg["sa0"]["mlp"][-1], cfg["sa1"]["mlp"][-1]
    s0_in, s1_in, _ = stage_widths(cfg)
    rows0 = float(count0.clamp(1, ns0).sum())
    rows1 = float(count1.clamp(1, ns1).sum())
    mlp0 = rows0 * mlp_flops_per_row(s0_in, cfg["sa0"]["mlp"])
    mlp1 = rows1 * mlp_flops_per_row(s1_in, cfg["sa1"]["mlp"])
    b = batch
    return {
        "fps": [(b * n * 12 + b * s0 * 16, DIST_OPS * b * (s0 - 1) * n, 0.0),
                (b * s0 * 12 + b * s1 * 16, DIST_OPS * b * (s1 - 1) * s0, 0.0)],
        "sa_select": [(4 * (b * n * 3 + b * s0 * 3 + b * s0 * ns0 + b * s0),
                       DIST_OPS * float(tests0.sum()), 0.0),
                      (4 * (b * s0 * 3 + b * s1 * 3 + b * s1 * ns1 + b * s1),
                       DIST_OPS * float(tests1.sum()), 0.0)],
        "sa_mlp": [(4 * (b * n * 4 + b * s0 * 3 + b * s0 * (ns0 + 1) + b * s0 * c0
                         + stage_params(cfg, "sa0")), 0.0, mlp0),
                   (4 * (b * s0 * 3 + b * s0 * c0 + b * s1 * 3 + b * s1 * (ns1 + 1)
                         + b * s1 * c1 + stage_params(cfg, "sa1")), 0.0, mlp1)],
        "model_flops": mlp0 + mlp1 + b * dense_flops_per_env(cfg),
    }


def kernel_bound_s(work, kernel, cfg):
    """The bound of one step's launches of ``kernel`` (fps, sa_select or
    sa_mlp), launch by launch; the MLP at the configuration's peak."""
    peak = PEAK[cfg["compute_dtype"]]
    return sum(bound_s(nbytes, dist, mlp, peak) for nbytes, dist, mlp in work[kernel])
