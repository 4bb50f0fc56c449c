"""Least time of the block-sparse dq and dk/dv kernels' calls over their
device time."""
from mrabench import readers


def read(run):
    return readers.roofline(run, ("bsa_bwd_dq", "bsa_bwd_dkv"),
                            ("bsa_bwd_dq", "bsa_bwd_dkv"))
