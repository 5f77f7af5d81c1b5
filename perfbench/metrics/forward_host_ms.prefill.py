"""Median host ms to launch one prefill chunk's eager forward: the
program's spans."""
from perfbench.harness.spans import prefill_host_ms


def read(ctx):
    return prefill_host_ms(ctx)
