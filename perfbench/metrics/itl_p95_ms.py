"""95th percentile of the gaps between consecutive tokens of one
request, both delivered in the window (harness clock)."""
from perfbench.harness.readers import tail_ms


def read(ctx):
    return tail_ms(ctx.itls())
