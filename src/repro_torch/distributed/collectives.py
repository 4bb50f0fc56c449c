"""Collectives over a mesh axis: the one module that calls torch.distributed.

Plain collectives (``all_reduce``, ``all_gather``, ``all_to_all``) and the
``torch.autograd.Function``s whose backward is the transpose that GSPMD /
``shard_map`` places in the reference:

  * ``copy_to``    identity forward, all-reduce (sum) backward: where a
                   replicated activation or parameter enters work split over
                   the axis (each rank's gradient is a partial sum);
  * ``reduce_from`` all-reduce (sum) forward, identity backward: where the
                   split work's partial results are summed back into a
                   replicated value;
  * ``mean_from``  all-reduce (mean) forward, identity backward (the
                   aux losses over the data axes, whose gradients the train
                   step averages);
  * ``gather_from`` all-gather forward, the rank's slice backward (the
                   replicated work after it gives every rank the same
                   gradient);
  * ``slice_to``   the rank's slice forward, all-gather backward;
  * ``exchange``   all-to-all forward, the inverse all-to-all backward.

Every op is the identity on an axis of size 1. Backends
(``launch.mesh.init_ranks``): NCCL when every rank has a card of its own,
gloo when ranks share a card or run on the CPU. Gloo lacks most
collectives on CUDA tensors, so on a gloo mesh every collective on a CUDA
tensor is staged through host memory here: copied to the CPU, reduced
there, copied back. The compute stays on the card. ``STATS`` counts calls,
bytes, seconds and staging seconds per op, and names the staged ops. The
timing adds no wait of its own: a staged collective's copy to the host
waits for the card anyway (its seconds are wall time, the card
synchronized at both ends), a CPU one runs on the host, and an NCCL one
stays queued on the stream like a kernel, timed by CUDA events that
``snapshot`` reads.

Under a ``launch.mesh.AbstractMesh`` (the dry run) an op calls nothing:
it records its payload as any op does (``STATS``; ``STATS.by_axis`` keeps
the bytes by op and axis) and returns an empty tensor of the result's
local shape on the input's device (meta in the dry run).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["STATS", "CommStats", "all_gather", "all_reduce", "all_to_all",
           "axis_size", "copy_to", "exchange", "gather_from", "mean_from",
           "reduce_from", "slice_to"]


class CommStats:
    """Per-op counters: calls, payload bytes, seconds and host-staging
    seconds (see the module docstring for what the seconds time)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ops: dict = {}
        self.by_axis: dict = {}  # (op, axis) -> payload bytes
        self.staged: set = set()
        self.pending: list = []  # (op, start, end) CUDA events not yet read

    def add(self, op: str, nbytes: int, seconds: float, staged_s: float,
            staged: bool, axis: str | None = None) -> None:
        if axis is not None:
            self.by_axis[op, axis] = self.by_axis.get((op, axis), 0) + nbytes
        s = self.ops.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                     "staging_seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        s["seconds"] += seconds
        s["staging_seconds"] += staged_s
        if staged:
            self.staged.add(op)

    def add_events(self, op: str, nbytes: int, start, end,
                   axis: str | None = None) -> None:
        """An unstaged collective on the card, timed by ``start`` / ``end``
        (read once they have completed, without waiting here)."""
        self.add(op, nbytes, 0.0, 0.0, False, axis)
        self.pending = [e for e in self.pending if not self._read(*e, False)]
        self.pending.append((op, start, end))

    def _read(self, op, start, end, wait: bool) -> bool:
        if not (wait or end.query()):
            return False
        end.synchronize()
        self.ops[op]["seconds"] += start.elapsed_time(end) / 1e3
        return True

    def snapshot(self) -> dict:
        for e in self.pending:
            self._read(*e, True)
        self.pending = []
        return {"ops": {k: dict(v) for k, v in sorted(self.ops.items())},
                "staged_ops": sorted(self.staged)}


STATS = CommStats()


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if mesh is not None and axis in mesh.shape else 1


def _run(op: str, t, mesh, axis: str, fn, shape=None):
    """Run ``fn(host_or_device_tensor, group) -> tensor`` on ``t``, staged
    through host memory on a gloo mesh when ``t`` is a CUDA tensor. Under
    an abstract mesh: record, and return an empty tensor of ``shape``
    (default: ``t``'s)."""
    nbytes = t.numel() * t.element_size()
    if getattr(mesh, "abstract", False):
        STATS.add(op, nbytes, 0.0, 0.0, False, axis)
        return t.new_empty(t.shape if shape is None else shape)
    x = t.detach()
    if t.is_cuda and mesh.backend != "gloo":  # NCCL: queued on the stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(x.contiguous(), mesh.group(axis))
        end.record()
        STATS.add_events(op, nbytes, start, end, axis)
        return out
    staged = t.is_cuda
    if staged:  # the copy to the host below waits for the card anyway
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    stage_s = 0.0
    if staged:
        x = x.to("cpu")
        stage_s += time.perf_counter() - t0
    out = fn(x.contiguous(), mesh.group(axis))
    if staged:
        t1 = time.perf_counter()
        out = out.to(t.device)
        torch.cuda.synchronize(t.device)
        stage_s += time.perf_counter() - t1
    STATS.add(op, nbytes, time.perf_counter() - t0, stage_s, staged, axis)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t, mesh, axis: str, op: str = "sum"):
    """A new tensor: ``t`` reduced over ``axis`` ("sum", "max", "min" or
    "mean")."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t.clone()

    def fn(x, group):
        y = x.clone()
        dist.all_reduce(y, op=_OPS["sum" if op == "mean" else op], group=group)
        return y

    out = _run("all_reduce", t, mesh, axis, fn)  # a new tensor
    return out.div_(n) if op == "mean" else out


def all_gather(t, mesh, axis: str, dim: int):
    """The ranks' tensors along ``axis`` concatenated on ``dim`` (rank
    order)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t.clone()

    def fn(x, group):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    shape = list(t.shape)
    shape[dim] *= n
    return _run("all_gather", t, mesh, axis, fn, shape)


def all_to_all(t, mesh, axis: str, split_dim: int, concat_dim: int):
    """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): ``t``
    split into |axis| chunks on ``split_dim``, chunk j sent to rank j; the
    chunks received concatenated on ``concat_dim`` in rank order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t.clone()
    nd = t.dim()
    split_dim %= nd
    concat_dim %= nd

    def fn(x, group):
        xs = x.movedim(split_dim, 0)
        xs = xs.reshape((n, xs.shape[0] // n) + xs.shape[1:]).contiguous()
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs, group=group)
        # (n, chunk...) with the split dim second: put it back, then merge
        # the source-rank dim into the concat dim
        out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
        shp = out.shape
        return out.reshape(shp[:concat_dim] + (n * shp[concat_dim + 1],)
                           + shp[concat_dim + 2:])

    shape = list(t.shape)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return _run("all_to_all", t, mesh, axis, fn, shape)


def _rank_slice(t, mesh, axis: str, dim: int):
    n = axis_size(mesh, axis)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axis) * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        return all_reduce(x, mesh, axis, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_rank_slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _rank_slice(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all(g, mesh, axis, concat_dim, split_dim), None, None, \
            None, None


def copy_to(x, mesh, axis: str = "model"):
    """Identity forward, all-reduce backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis: str = "model"):
    """All-reduce (sum) forward, identity backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis, "sum")


def mean_from(x, mesh, axis: str = "data"):
    """All-reduce (mean) forward, identity backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis, "mean")


def gather_from(x, mesh, axis: str, dim: int):
    """All-gather on ``dim`` forward, the rank's slice backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)


def slice_to(x, mesh, axis: str, dim: int):
    """The rank's slice of ``dim`` forward, all-gather backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SliceTo.apply(x, mesh, axis, dim)


def exchange(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """Tiled all-to-all forward, the inverse all-to-all backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Exchange.apply(x, mesh, axis, split_dim, concat_dim)
