"""Real prompt rows over padded rows computed in prefill chunks, %."""
from perfbench.harness.readers import chunk_fill


def read(ctx):
    return chunk_fill(ctx)
