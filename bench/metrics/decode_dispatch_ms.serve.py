"""Mean wall ms of a decode dispatch (a whole decode wave) of the
engine."""
from mrabench import readers


def read(run):
    return readers.dispatch_ms(run, "decode")
