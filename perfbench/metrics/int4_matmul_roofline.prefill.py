"""Bound time of the projections over `int4_matmul`'s device time, %."""
from perfbench.harness.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "int4_matmul", "proj")
