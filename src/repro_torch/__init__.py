"""PyTorch + CUDA port of the MRA-2 serving and training stack
(reference: ``repro``).

The JAX package ``repro`` is the reference implementation; this package
mirrors its layout module by module (``repro_torch/core/mra_decode.py`` is
the port of ``repro/core/mra_decode.py``, and so on) and never imports it.
Both paths of the dense decoder run on an NVIDIA Hopper card through
hand-written CUDA kernels, built at first use by ``kernels/build.py``:

  * serving — chunk/decode MRA-2 attention over the ring-paged cache,
    ``csrc/chunk_attn.cu``;
  * training — full-sequence MRA-2 attention, whose high-resolution term
    runs the block-sparse forward, dq and dk/dv kernels of
    ``csrc/block_sparse_attn.cu``.

Entry points (``serve.Engine``, ``serve.cache.RingPagedKVCache``,
``train.train``, ``models.params.init_params``) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card and without that request
they raise.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    ``None`` means the card; there is no silent fallback to the CPU, so a
    run that expects the GPU fails loudly instead of measuring the wrong
    device. Pass ``device="cpu"`` to run the plain PyTorch versions.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
