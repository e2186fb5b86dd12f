"""Host launch calls (kernel launches; a graph launch counts once) of the
traced rollout, as the profiler records them, per env-step batch (per
policy step). Moves ``env_steps_per_s``."""


def read(ctx):
    launches = ctx["trace"].launches
    return launches / ctx["steps"] if launches else None
