"""setup_s: seconds from the start of the process to the start of the
window."""


def read(ctx):
    return ctx.get("setup_s")
