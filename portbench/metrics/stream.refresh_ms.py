"""stream.refresh_ms: milliseconds of the engine's host HDP refresh a
chunk, synchronised."""


def read(ctx):
    r = ctx.get("refresh_s")
    return 1e3 * sum(r) / len(r) if r else None
