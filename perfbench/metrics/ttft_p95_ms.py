"""95th percentile of the time from submit to first token, over the
requests whose first token came in the window (harness clock)."""
from perfbench.harness.readers import tail_ms


def read(ctx):
    return tail_ms(ctx.ttfts())
