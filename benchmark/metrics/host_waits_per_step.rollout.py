"""Blocking copies from the host to the card a policy step of the traced
rollout: the program's ``wait.*`` spans (one a copy, each of which drains
the card's queue before the host goes on) over its steps. None where the
program opens no ``rollout.env`` span. Moves ``env_steps_per_s``."""

from benchmark import spans


def read(ctx):
    return spans.waits_per_step(ctx, "rollout.env")
