"""Median ms on the device's clock from the launch of the decode dispatch of
an engine step with no prefill chunk to the end of its device work (CUDA
events around the graph's launch and replay): the program's spans. The
device's idle while the host launches is in it, so it is no device time."""
from perfbench.harness.spans import decode_wall_ms


def read(ctx):
    return decode_wall_ms(ctx)
