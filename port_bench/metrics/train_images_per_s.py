"""Images trained per second: every step of the window over its length."""


def read(ctx):
    w = ctx["window"]
    return w["steps"] * ctx["traffic"]["batch"] / w["seconds"]
