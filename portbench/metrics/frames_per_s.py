"""frames_per_s: camera frames whose maps reached the host, divided by the
window (from its start to the end of its last call)."""


def read(ctx):
    t = ctx.timings
    return len(t.frame_lat) / t.window_s if t.window_s > 0 else None
