"""Bound time of attention over `paged_attention`'s device time, %."""
from perfbench.harness.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "paged_attention", "attn")
