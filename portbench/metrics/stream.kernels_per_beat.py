"""stream.kernels_per_beat: device kernels in the profiled chunk over its
beats."""


def read(ctx):
    s = ctx.get("slice")
    return s["n_kernels"] / s["beats"] if s and s.get("beats") else None
