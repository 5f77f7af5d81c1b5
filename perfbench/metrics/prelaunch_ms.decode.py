"""Median ms from the start of an engine step with no prefill chunk to its
decode launch (admission, page growth, the inputs and their copies): the
program's spans."""
from perfbench.harness.spans import prelaunch_ms


def read(ctx):
    return prelaunch_ms(ctx)
