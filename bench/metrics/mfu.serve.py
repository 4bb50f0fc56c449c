"""Model operations of the served tokens over the window at the bf16 peak."""
from mrabench import readers


def read(run):
    return readers.mfu(run)
