"""Mean decode rows per engine step over the window."""
from perfbench.harness.readers import decode_rows


def read(ctx):
    return decode_rows(ctx)
