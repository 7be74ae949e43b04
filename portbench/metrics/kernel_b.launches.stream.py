"""kernel_b.launches.stream: kernel-B launches a beat (counter
spd_solve.launches)."""


def read(ctx):
    b = ctx.get("beats")
    return ctx["spd_launches"] / b if b else None
