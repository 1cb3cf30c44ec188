"""Process start to the first timed call: CUDA context, the build of the
kernels where the checkout has none, the rows made and added, the query
pool and selector sets, and the warm-up that captures every program."""


def read(run):
    return run.setup_s
