"""Real prompt tokens (not padding) whose prefill completed in the
window, over its length."""


def read(ctx):
    n = sum(r for rec in ctx.records for _, r, _ in rec.chunks)
    return n / ctx.window_s
