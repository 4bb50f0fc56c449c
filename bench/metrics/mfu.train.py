"""Model operations of the trained tokens (forward and backward, no
recompute) over the window at the bf16 peak."""
from mrabench import readers


def read(run):
    return readers.mfu(run)
