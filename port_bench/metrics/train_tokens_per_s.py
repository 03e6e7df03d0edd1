"""Tokens trained per second: every step of the window over its length."""


def read(ctx):
    w, tr = ctx["window"], ctx["traffic"]
    return w["steps"] * tr["batch"] * tr["seq_len"] / w["seconds"]
