"""Median ms from the end of the token transfer of an engine step with no
prefill chunk to the step's end (commit, accounting, stream flush): the
program's spans."""
from perfbench.harness.spans import postsync_ms


def read(ctx):
    return postsync_ms(ctx)
