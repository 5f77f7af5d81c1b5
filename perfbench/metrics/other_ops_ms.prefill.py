"""Device ms per prefill chunk of kernels other than the hand-written
ones."""
from perfbench.harness.readers import other_ops_ms


def read(ctx):
    return other_ops_ms(ctx, "chunk")
