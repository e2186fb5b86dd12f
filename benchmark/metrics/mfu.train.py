"""The train steps' FLOP over the time as many steps took untraced (the
mean over the rest of the window), against the configuration's peak (bf16
989, f32 67 TFLOP/s), in %: the forward over the rows the traced batches'
clouds need (by the reference's ball query), and the backward counted as
twice the forward. Moves ``train_samples_per_s``."""

from benchmark import counts

BACKWARD = 2.0   # the backward's FLOP, in forwards


def read(ctx):
    work = ctx["work"]
    if not work or not ctx["unit_s"] or not ctx["trace"].device:
        return None
    flops = (1.0 + BACKWARD) * sum(w["model_flops"] for w in work) / len(work) * ctx["steps"]
    return 100.0 * flops / ctx["unit_s"] / counts.PEAK[ctx["cfg"]["compute_dtype"]]
