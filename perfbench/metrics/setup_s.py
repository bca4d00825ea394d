"""Process start to the first timed step: imports and the CUDA context,
weights, the pool on the card, and the warm-up of the cell's shapes (in
a checkout's first run also the kernels' build)."""


def read(run):
    return run.setup_s
