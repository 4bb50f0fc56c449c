"""Least time of the block-sparse forward kernel's calls over its device time."""
from mrabench import readers


def read(run):
    return readers.roofline(run, ("bsa_fwd",), ("bsa_fwd",))
