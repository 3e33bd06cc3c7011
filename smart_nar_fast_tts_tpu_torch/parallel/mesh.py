"""The device mesh of the port, as ``smart_nar_fast_tts_tpu/parallel/mesh.py``.

In the JAX package one process drives every local device through one
``jax.sharding.Mesh``.  The port follows PyTorch's idiom instead: one process
per card, launched by ``torchrun`` (``python -m torch.distributed.run``).  A
rank stands for a JAX device; the ranks of one node stand for a JAX process.

- :func:`init_distributed` joins the process group (NCCL on CUDA, gloo on
  the CPU) and selects the rank's card.
- :func:`make_mesh` lays the ranks out on named axes, row-major as
  ``np.reshape`` of the rank ids, with one process group per line of each
  axis (:func:`line_group`: the default group for a line of every rank);
  a single ``-1`` absorbs the world size.
- :func:`batch_sharding` is a rank's contiguous rows of a batch along an
  axis, the row layout of JAX's ``NamedSharding(mesh, P(axis))``.
- :func:`replicated` broadcasts parameters from the mesh's first rank, so
  that every rank holds the same ones after an init or a restore.

Without a process group a mesh holds one rank and no groups: every
collective of the port is then skipped.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
COLLECTIVE_TIMEOUT_S = 600

TORCHRUN_HINT = ("launch with torchrun (python -m torch.distributed.run "
                 "--nproc_per_node N -m ...), which sets WORLD_SIZE, RANK, "
                 "LOCAL_RANK, MASTER_ADDR and MASTER_PORT")


def init_distributed(device: str | torch.device | None = None,
                     require: bool = False,
                     init_method: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group when launched by torchrun with
    ``WORLD_SIZE`` > 1, or with ``require`` at any world size; returns
    whether a group is up.  ``require`` raises when the torchrun
    environment is missing.  On CUDA (``device`` None or ``"cuda"``) the
    backend is NCCL and the rank's card becomes the current device, so
    that ``resolve_device(None)`` is that card; on the CPU it is gloo.
    ``init_method`` defaults to ``env://`` and ``timeout_s`` to
    ``COLLECTIVE_TIMEOUT_S``."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("WORLD_SIZE", "RANK",
                                         "LOCAL_RANK")):
        if require:
            raise RuntimeError("--distributed needs the torchrun "
                               "environment: " + TORCHRUN_HINT)
        return False
    world = int(os.environ["WORLD_SIZE"])
    if world <= 1 and not require:
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the ranks on the CPU over gloo")
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=init_method or "env://",
        rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(
            seconds=timeout_s or COLLECTIVE_TIMEOUT_S))
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def node_layout() -> tuple[int, int, int]:
    """(node index, node count, ranks per node) from torchrun's
    environment; (0, 1, world size) without it."""
    rank, size = world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    return rank // local, max(1, size // local), local


# the process groups of the lines of every mesh built so far, by their
# ranks, for the default group in ``_LINES_OF``
_LINES: dict = {}
_LINES_OF = None


def line_group(ranks: tuple):
    """The process group of ``ranks`` (every rank calls this for every
    line, in the same order): the default group when they are every rank,
    None for a single rank of a larger world (its collectives are
    skipped), else one group per set of ranks, made at its first call and
    shared by every later mesh.  So one set of ranks never holds two NCCL
    communicators, and a second Trainer or CLI in the process makes
    none."""
    global _LINES_OF
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    if _LINES_OF is not dist.group.WORLD:
        _LINES.clear()
        _LINES_OF = dist.group.WORLD
    if ranks not in _LINES:
        _LINES[ranks] = dist.new_group(list(ranks))
    return _LINES[ranks]


class Mesh:
    """The ranks of the default group on named axes.

    ``shape`` maps each axis name to its size and ``devices`` is the grid of
    rank ids, as a JAX mesh's; ``coords`` is this rank's index on each axis
    and :meth:`group` the process group of the line through this rank along
    an axis (None without a process group, and for a line of one rank in a
    larger world)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        rank, size = world()
        self.devices = np.arange(size).reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{self.axis_names} differ in length")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        here = np.argwhere(self.devices == rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in here)))
        self._groups = {}
        if dist.is_initialized():
            # every rank visits every line, in the same order
            for i, name in enumerate(self.axis_names):
                lines = np.moveaxis(self.devices, i, -1).reshape(
                    -1, self.devices.shape[i])
                for line in lines:
                    group = line_group(tuple(line.tolist()))
                    if rank in line:
                        self._groups[name] = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"{axis!r} is not a mesh axis "
                             f"{self.axis_names}")
        return self._groups.get(axis)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names ==
                other.axis_names and np.array_equal(self.devices,
                                                    other.devices))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh over every rank; a single ``-1`` absorbs the remaining world
    size (like a reshape wildcard)."""
    _, size = world()
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = size // known
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the "
                         f"world of {size} ranks")
    return Mesh(shape, axis_names)


def trivial(mesh: Optional[Mesh]) -> bool:
    """True for no mesh or a mesh of one rank (JAX's ``_trivial_mesh``)."""
    return mesh is None or mesh.size == 1


@dataclass(frozen=True)
class BatchSharding:
    """Part ``index`` of ``count`` equal contiguous runs of rows."""
    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} rows does not shard over "
                             f"{self.count} ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def __call__(self, x):
        """The rows of a tensor, or of every tensor of a NamedTuple batch
        (None fields stay None)."""
        if isinstance(x, tuple):
            n = next(t for t in x if t is not None).shape[0]
            return type(x)(*(None if t is None else t[self.rows(n)]
                             for t in x))
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh: Mesh, axis: str = "data",
                   num_hosts: int = 1) -> BatchSharding:
    """This rank's rows along ``axis``: of the global batch, or with
    ``num_hosts`` nodes of the node's own batch (the data slots of a node
    are consecutive on a leading data axis)."""
    count = mesh.shape[axis] // num_hosts
    return BatchSharding(mesh.coords[axis] % count, count)


def replicated(mesh: Mesh, *modules: torch.nn.Module) -> None:
    """Make every parameter and buffer of ``modules`` identical on every
    rank: broadcast from the mesh's first rank (no-op without a process
    group)."""
    if not dist.is_initialized():
        return
    src = int(mesh.devices.flat[0])
    for module in modules:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """A reduced copy of ``t`` over ``group`` (sum by default); ``t``
    itself when ``group`` is None.  Not differentiable."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order (``x`` itself when ``group`` is None).  Not differentiable."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the same sum: each rank's loss is
    one part of a sum over the group, so each rank's input reaches every
    part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``x`` when None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_over_mesh(mesh: Optional[Mesh], params, divisor: float,
                     buffers=()) -> None:
    """One all-reduce over every rank of ``mesh`` (the default group): each
    parameter's ``.grad`` summed and divided by ``divisor``, each tensor of
    ``buffers`` averaged.  Ranks that compute the same rows (the seq ranks
    of a ring, a tail axis such as ``model``) are equal in exact arithmetic
    only: the card's nondeterministic kernels (cuDNN's and the embedding's
    backward sum in no fixed order) would let them drift apart, and this
    averages them back.  A parameter without a gradient is skipped: the
    ranks run the same graph, so the same ones have none on every rank.
    No-op without a mesh or a process group."""
    if mesh is None or not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    buffers = list(buffers)
    flat = torch.cat([t.reshape(-1) for t in grads + buffers])
    dist.all_reduce(flat)
    offset = 0
    for ts, d in ((grads, float(divisor)), (buffers, float(mesh.size))):
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t) / d)
            offset += t.numel()
