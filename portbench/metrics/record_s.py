"""record_s: the window's seconds over the records it clustered (each
record a fresh model on the cell's beats, swept until its partition
repeats)."""


def read(ctx):
    return ctx["window_s"] / ctx["records"] if ctx.get("records") else None
