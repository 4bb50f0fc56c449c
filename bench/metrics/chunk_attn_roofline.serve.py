"""Least time of the serving kernel's calls over its device time (its
combine kernel included)."""
from mrabench import readers


def read(run):
    return readers.roofline(run, ("chunk_attn",), ("chunk_attn",))
