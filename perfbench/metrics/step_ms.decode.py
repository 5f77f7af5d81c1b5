"""Median host ms of `engine.step()` over the window."""
from perfbench.harness.readers import step_ms


def read(ctx):
    return step_ms(ctx)
