"""Share of its roofline of the SA MLP kernels (`sa_kernel_mma` in bf16,
`sa_kernel<...>` in f32) over the traced rollout: the sum of the launches'
bounds (`counts.kernel_bound_s` of the kept steps' work, times the steps)
over their summed device time, in %.
Moves ``env_steps_per_s``."""

import re

from benchmark import counts, trace

NAME = re.compile(r"(?<![A-Za-z0-9_])sa_kernel(_mma)?(?![A-Za-z0-9_])")


def read(ctx):
    measured = trace.kernel_us(ctx["trace"], lambda n: NAME.search(n) is not None) / 1e6
    if not measured or not ctx["work"]:
        return None
    per_step = sum(counts.kernel_bound_s(w, "sa_mlp", ctx["cfg"]) for w in ctx["work"])
    return 100.0 * per_step / len(ctx["work"]) * ctx["steps"] / measured
