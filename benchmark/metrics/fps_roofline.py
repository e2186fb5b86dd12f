"""Share of its roofline of the FPS kernel (`fps_kernel`) over the traced
rollout: the sum of the launches' bounds (`counts.kernel_bound_s` of the
kept steps' work, times the steps) over their summed device time, in %.
Moves ``env_steps_per_s``."""

import re

from benchmark import counts, trace

NAME = re.compile(r"fps_kernel")


def read(ctx):
    measured = trace.kernel_us(ctx["trace"], lambda n: NAME.search(n) is not None) / 1e6
    if not measured or not ctx["work"]:
        return None
    per_step = sum(counts.kernel_bound_s(w, "fps", ctx["cfg"]) for w in ctx["work"])
    return 100.0 * per_step / len(ctx["work"]) * ctx["steps"] / measured
