"""Device idle milliseconds a policy step of the traced rollout in the gaps
that begin while the host is inside a ``rollout.env`` span (its ``wait.*``
spans included). None where the profile has no such span. Moves
``env_steps_per_s``."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(spans.idle_us_in(ctx["trace"], "rollout.env"), ctx)
