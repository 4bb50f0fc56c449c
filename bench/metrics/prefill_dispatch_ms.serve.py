"""Mean wall ms of a chunked-prefill dispatch of the engine."""
from mrabench import readers


def read(run):
    return readers.dispatch_ms(run, "prefill")
