"""Drivers of the port, run as ``python -m repro_torch.examples.<name>``:
``quickstart``, ``serve_decode``, ``approx_demo`` and ``train_lm``
(ports of the reference's ``examples/``). Each runs on the card unless
given ``--device cpu``."""
