"""Device milliseconds a step of the kernels launched under autograd's
``SAStageTrainBackward`` nodes (the SA stages' plain-torch backward,
``model/fused_train.py``), over the traced steps. Moves
``train_samples_per_s``."""

from benchmark import trace


def read(ctx):
    us = trace.kernel_us_under_node(ctx["prof"], "SAStageTrainBackward")
    if not us or not ctx["steps"]:
        return None
    return us / 1e3 / ctx["steps"]
