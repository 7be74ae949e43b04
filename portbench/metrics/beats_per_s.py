"""beats_per_s: beats the stream engine clustered in the window over its
seconds."""


def read(ctx):
    return ctx["beats"] / ctx["window_s"] if ctx.get("beats") else None
