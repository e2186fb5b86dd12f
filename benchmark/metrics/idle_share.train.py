"""Share of the train steps' wall time in which no operation ran on the
device: 1 - (union of the device's operation intervals over the traced
steps) / (the time as many steps took untraced, by the mean over the rest
of the window), in %. Moves ``train_samples_per_s``."""

from benchmark import trace


def read(ctx):
    return trace.unit_idle_share(ctx)
