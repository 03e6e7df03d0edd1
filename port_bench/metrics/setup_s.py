"""Set-up: from the start of the process to the first timed step (the
weights, the batches, the checked first steps, the warm-up)."""


def read(ctx):
    return ctx["setup_s"]
