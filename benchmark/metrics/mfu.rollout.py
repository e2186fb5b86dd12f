"""The policy's FLOP of a rollout over the time the window's untraced
rollouts took (their median), against the configuration's peak (bf16 989,
f32 67 TFLOP/s), in %. The SA stages count only the rows the inputs need
(each centroid's neighbours, up to 128, by the reference's ball query at the
traced rollout's kept steps). Moves ``env_steps_per_s``."""

from benchmark import counts


def read(ctx):
    work = ctx["work"]
    if not work or not ctx["unit_s"] or not ctx["trace"].device:
        return None
    flops = sum(w["model_flops"] for w in work) / len(work) * ctx["steps"]
    return 100.0 * flops / ctx["unit_s"] / counts.PEAK[ctx["cfg"]["compute_dtype"]]
