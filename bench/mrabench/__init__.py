"""The benchmark of ``repro_torch``: one cell, one run (``bench/run.py``).

Everything that measures lives here, apart from the program: the traffic
generators, the weights drawn from the seed, the plain reference that
decides ``correct``, the H100 peaks and work formulas, and the reading of
the profiler's trace. Nothing here imports JAX or the JAX package.
"""
