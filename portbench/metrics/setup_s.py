"""setup_s: seconds from the process's start to the window's: importing,
making weights and traffic, building the runtime (and, in a checkout's
first run, the kernels), and the pre-roll that warms every shape."""


def read(ctx):
    return ctx.setup_s
