"""Seconds from process start to the start of the window."""


def read(ctx):
    return ctx.setup_s
