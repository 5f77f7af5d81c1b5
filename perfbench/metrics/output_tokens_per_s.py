"""Tokens delivered in the window over its length."""


def read(ctx):
    return ctx.tokens_in_window() / ctx.window_s
