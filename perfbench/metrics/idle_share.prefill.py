"""Share of the traced slice in which no device operation ran, %."""
from perfbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
