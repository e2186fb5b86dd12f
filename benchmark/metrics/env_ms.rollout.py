"""Device milliseconds a policy step of the traced rollout of the
operations launched under the program's ``rollout.env`` spans: joint
update, unnormalize, success predicate, step counts, robot resample, cloud
update. None where the profile has no such span. Moves
``env_steps_per_s``."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(spans.device_us_under(ctx["prof"], "rollout.env"), ctx)
