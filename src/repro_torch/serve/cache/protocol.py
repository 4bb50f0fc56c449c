"""Per-layer cache protocol: the engine-facing contract every backend meets.

Port of ``repro/serve/cache/protocol.py``. The engine plans chunks and
decode waves; the model functions own the cache tree's layout and
numerics. What the engine needs from the cache object is lifecycle +
introspection:

  tree           the dict of tensors handed to every model call
  specs          the TensorSpec tree that declared it
  capacity       per-slot token budget for admission control, or None
                 when prompts of any length may stream through (H >= 3,
                 and the recurrent state)
  chunk_cap      optional ceiling on the engine's prefill chunk size
  paged          ring-paged MRA semantics (page table + pyramid)
  supports_spec  whether spec_snapshot / spec_rewind exist: speculation
                 drafts through the MRA pyramid and rewinds the ring, so
                 only the ring-paged MRA cache has them (the defaults raise)
  kinds          the model's per-layer cache kinds (``make_cache`` sets it)
  reset_slots    bit-exact per-slot reset on (re)admission
  lengths        (slots,) host view of per-slot stream lengths
  rows / whole   the rank's rows of a per-slot input / a per-slot output
                 gathered over every slot: the one place that knows how
                 the slots are split over a mesh (the identity otherwise;
                 ``mesh=`` places the tree by ``place_specs``)

Which backend serves a model is decided from the model's per-layer
``layer_cache_kinds(cfg)`` (``make_cache`` in __init__.py). The fixed-size
state backends share ``StateCache``: the tree is exactly the model's
``cache_specs``, filled by the specs' constants, and reset per slot by
rewriting its rows with them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (
    ShardingRules,
    local_shape,
    logical_to_pspec,
)
from repro_torch.models.params import fill_value, materialize

__all__ = ["CacheBackend", "StateCache", "fill_value", "make_state_reset",
           "place_specs"]


def place_specs(specs: dict, mesh) -> dict:
    """The cache specs of the rank's blocks on ``mesh``: every tensor placed
    by its axes (batch -> data, kv-heads and the rwkv6 state's heads ->
    model), the sequence axis kept whole (the reference's ``kv_seq`` data
    split, taken only when the slots do not divide the data axis, is not
    ported: the slots are then replicated over it)."""
    rules = ShardingRules().override(kv_seq=())

    def one(s):
        pspec = logical_to_pspec(s.shape, s.axes, mesh, rules)
        return s._replace(shape=local_shape(s.shape, pspec, mesh))

    return {k: [one(x) for x in v] if isinstance(v, list) else one(v)
            for k, v in specs.items()}


class CacheBackend:
    """Base class carrying the protocol defaults (see module docstring)."""

    paged = False
    supports_spec = False
    capacity: int | None = None
    chunk_cap: int | None = None
    kinds: tuple = ()
    mesh = None
    row_split = False  # the slots split over the data axes

    def reset_slots(self, mask: np.ndarray) -> None:
        raise NotImplementedError

    def _place(self, mesh) -> None:
        """Cut ``self.specs`` to the rank's blocks on ``mesh`` (None: keep
        them whole)."""
        self.mesh = mesh
        if mesh is not None:
            n = self.specs["lengths"].shape[0]
            self.specs = place_specs(self.specs, mesh)
            self.row_split = self.specs["lengths"].shape[0] != n

    def rows(self, x):
        """The rank's rows of a per-slot array (every slot's, (slots, ...))."""
        n = self.specs["lengths"].shape[0]
        if not self.row_split or x.shape[0] == n:
            return x
        i = self.mesh.index("data")
        return x[i * n:(i + 1) * n]

    def whole(self, t):
        """A per-slot array of the rank's slots gathered over every slot."""
        if not self.row_split:
            return t
        return C.all_gather(t, self.mesh, "data", 0)

    @property
    def lengths(self) -> np.ndarray:
        return self.whole(self.tree["lengths"]).cpu().numpy()

    def occupancy(self) -> dict:
        """Uniform occupancy gauges: ``slots_active``, ``tokens_live``,
        ``pages_live`` and ``tokens_evicted``."""
        lengths = self.lengths
        return {
            "slots_active": float((lengths > 0).sum()),
            "tokens_live": float(lengths.sum()),
            "pages_live": 0.0,
            "tokens_evicted": 0.0,
        }

    # speculative decoding is a ring-paged feature (DESIGN.md §10/§12)
    def spec_snapshot(self, window: int):
        raise NotImplementedError(
            "speculative rounds need the ring-paged MRA cache "
            "(pyramid pages are the draft model)")

    def spec_rewind(self, snap, target_lengths, gate, chunk_kv=None):
        raise NotImplementedError(
            "speculative rounds need the ring-paged MRA cache "
            "(pyramid pages are the draft model)")


def make_state_reset(items: tuple):
    """Bit-exact slot reset of a state-cache tree, in place.

    ``items`` is a tuple of (key, fill) pairs. Layout shared by the state
    backends: ``lengths`` is (slots,); every other leaf is (layers, slots,
    ...), the slot axis second. Returns ``reset(tree, mask)`` with ``mask``
    a (slots,) bool tensor on the tree's device.
    """

    @torch.no_grad()
    def reset(tree, mask):
        for key, fill in items:
            a = tree[key]
            m = mask if key == "lengths" else mask.reshape(
                (1, -1) + (1,) * (a.ndim - 2))
            a.masked_fill_(m, fill)
        return tree

    return reset


class StateCache(CacheBackend):
    """Shared lifecycle of fixed-size per-slot state trees (no paging).

    The tree is exactly ``model.cache_specs(cfg, slots, max_len)``, made on
    ``device`` (default: cuda) at the specs' constants: the model owns the
    layout, this class the init and the reset. The state per slot does not
    grow with the stream, so there is no admission capacity: ``capacity``
    stays None and the scheduler accepts any prompt and generation length.
    Under ``mesh`` the tree holds the rank's blocks (``place_specs``: the
    slots over the data axes, the rwkv6 state's heads over "model"), reset
    by the rank's rows of the mask.
    """

    capacity = None

    def __init__(self, cfg, model, slots: int, max_len: int, *, device=None,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        self.specs = model.cache_specs(cfg, slots, max_len)
        self._place(mesh)
        self.tree = {k: materialize(s, self.device)
                     for k, s in self.specs.items()}
        self._reset = make_state_reset(
            tuple(sorted((k, fill_value(s)) for k, s in self.specs.items())))

    def reset_slots(self, mask: np.ndarray) -> None:
        self._reset(self.tree, torch.as_tensor(
            self.rows(np.asarray(mask, bool)), device=self.device))
