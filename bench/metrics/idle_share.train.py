"""Share of the traced training window with no kernel on the device."""
from mrabench import readers


def read(run):
    return readers.idle_share(run)
