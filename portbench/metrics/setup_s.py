"""Process start to the end of the warm-up book: imports, the CUDA
context, the kernels' load (their build on a checkout's first run), the
book made (its pages written on a checkout's first run, linked after),
and one recode of it."""


def read(run):
    return run.setup_s
