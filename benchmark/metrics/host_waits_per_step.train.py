"""Blocking copies from the host to the card a traced train step, batch
building included: the program's ``wait.*`` spans over the steps. None
where the program opens no ``train.step`` span. Moves
``train_samples_per_s``."""

from benchmark import spans


def read(ctx):
    return spans.waits_per_step(ctx, "train.step")
