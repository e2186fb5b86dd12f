"""Device idle milliseconds a traced train step in the gaps that begin
while the host is inside a ``train.batch`` span (the batch built on the
card). None where the profile has no such span. Moves
``train_samples_per_s``."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(spans.idle_us_in(ctx["trace"], "train.batch"), ctx)
