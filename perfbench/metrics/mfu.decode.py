"""Counted work of the traced slice at its classes' peaks over the
slice's length, %."""
from perfbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)
