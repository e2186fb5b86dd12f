"""Share of a rollout's wall time in which no operation ran on the device:
1 - (union of the device's operation intervals over the traced rollout) /
(the median time of the window's untraced rollouts), in %. Moves
``env_steps_per_s``."""

from benchmark import trace


def read(ctx):
    return trace.unit_idle_share(ctx)
