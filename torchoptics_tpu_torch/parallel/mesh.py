"""Process groups, the ('lens', 'rays') mesh and its collectives.

PyTorch counterpart of ``torchoptics_tpu.parallel.mesh``. The workload is
data parallel over its two embarrassingly parallel axes:

* ``lens``: systems of a design population;
* ``rays``: pupil samples within one trace.

Lens parameters are tiny and replicated on every rank; each rank traces its
(systems x pupil samples) block, and the only traffic is the sum of loss
moments and of parameter gradients. So every collective here is an
``all_reduce`` or a ``broadcast``, which both backends take on CUDA tensors:
NCCL when every rank has a GPU of its own, gloo when ranks share one (NCCL
refuses two ranks on one device, and gloo has no ``all_gather`` of CUDA
tensors).

A rank's gradients are its own share, as under ``shard_map``: a sum over
ranks (:meth:`Mesh.sum`, ``psum``) is replicated, and its backward passes
the replicated cotangent through unchanged; a replicated value that feeds
a rank's own block (a centroid that each rank's rays deviate from) passes
through :meth:`Mesh.vary` (``pvary``), whose backward sums the ranks'
partial cotangents. The world-sum of the ranks' parameter gradients
(:meth:`Mesh.sum_gradients`) is then the gradient of the single-process
loss.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LENS_AXIS = "lens"
RAY_AXIS = "rays"
AXES = (LENS_AXIS, RAY_AXIS)

#: How long a rank waits in a collective before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> Tuple[str, torch.device]:
    """Join this process to a process group and bind it to its device.

    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment, as ``jax.distributed.initialize``
    reads its own), ``world_size`` and ``rank`` to ``WORLD_SIZE`` and
    ``RANK``. The rank runs on ``cuda:{LOCAL_RANK % device_count}`` when a
    GPU is present (``LOCAL_RANK`` defaults to the rank), else on the CPU;
    ``device="cpu"`` keeps it on the CPU.

    ``backend=None`` picks by rule: NCCL when every rank of this host has a
    GPU of its own (``LOCAL_WORLD_SIZE``, default the world size, at most
    the device count), gloo when ranks share one or run on the CPU. A failed
    NCCL start raises; it does not turn into gloo.

    Returns (backend, device)."""
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    on_gpu = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    if on_gpu:
        n_dev = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local_rank % n_dev)
        torch.cuda.set_device(device)
        own_gpu = int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) <= n_dev
        chosen = "nccl" if own_gpu else "gloo"
    else:
        device = torch.device("cpu")
        chosen = "gloo"
    backend = backend or chosen
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    return backend, device


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward passes the cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Vary(torch.autograd.Function):
    """The identity; the backward sums the cotangent over a process group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce`` (sum) of ``x`` over ``group`` (the world by default),
    differentiable. Its backward passes the replicated cotangent through
    unchanged, the transpose of ``psum`` under ``shard_map``: every rank
    holds the same replicated result and its same cotangent, so summing the
    cotangents (the backward of ``torch.distributed.nn``'s all_reduce)
    would scale each rank's gradient by the group's size."""
    return _AllReduceSum.apply(x, group)


@dataclass(frozen=True)
class Mesh:
    """A 2-D (lens, rays) layout of the world's ranks, row-major as
    ``np.reshape(ranks, (lens, rays))``; this rank's coordinates, and for
    each axis the process group of the ranks that differ from this one along
    it only. A single process without a process group is the 1 x 1 mesh, on
    which every collective is the identity."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int = 0
    world_size: int = 1
    groups: Dict[str, object] = field(default_factory=dict, compare=False)

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def _group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (None: the world)."""
        return None if set(axes) == set(AXES) else self.groups[axes[0]]

    def sum(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """Differentiable sum of ``x`` over the ranks along ``axes`` (both:
        the world); the identity where they span one rank."""
        if self.size(*axes) == 1:
            return x
        return all_reduce_sum(x, self._group(axes))

    def vary(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """``x``, a value replicated along ``axes``, for use in this rank's
        own block: the identity, whose backward sums the ranks' partial
        cotangents over ``axes``."""
        if self.size(*axes) == 1:
            return x
        return _Vary.apply(x, self._group(axes))

    def sum_gradients(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum the ``.grad`` of ``tensors`` over the world, in place, in one
        ``all_reduce`` (a missing gradient counts as zeros)."""
        tensors = list(tensors)
        if self.world_size == 1 or not tensors:
            return
        grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in tensors]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        for t, part in zip(tensors, torch.split(flat, [g.numel() for g in grads])):
            t.grad = part.view_as(t).clone()

    def broadcast_(self, tensors: Iterable[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` in place with rank ``src``'s values."""
        if self.world_size == 1:
            return
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=src)


def make_mesh(lens_parallel: int = 1) -> Mesh:
    """Build the 2-D ('lens', 'rays') mesh over the world's ranks.

    ``lens_parallel`` ranks shard the system batch; the rest shard rays.
    With the default (1), all ranks shard the ray block: the layout for
    single-design optimization, where rays are the only large axis. Every
    rank must call it, in the same order (it creates process groups)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if lens_parallel < 1 or n % lens_parallel:
        raise ValueError(f"{n} ranks not divisible by lens_parallel={lens_parallel}")
    n_rays = n // lens_parallel
    shape = {LENS_AXIS: lens_parallel, RAY_AXIS: n_rays}
    if n == 1:
        return Mesh(shape, {LENS_AXIS: 0, RAY_AXIS: 0})
    rank = dist.get_rank()
    li, ri = divmod(rank, n_rays)
    groups = {}
    # new_group is collective: every rank creates every group, in one order.
    for axis, count, members in (
            (LENS_AXIS, n_rays, lambda r: [l * n_rays + r for l in range(lens_parallel)]),
            (RAY_AXIS, lens_parallel, lambda l: [l * n_rays + r for r in range(n_rays)])):
        for j in range(count):
            ranks = members(j)
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape, {LENS_AXIS: li, RAY_AXIS: ri}, rank, n, groups)


def axis_block(mesh: Mesh, axis: str, n: int) -> slice:
    """This rank's block of an axis of length ``n``, a multiple of the
    mesh axis ``axis``."""
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} is not a multiple of the {axis!r} axis ({size}); pad it first")
    n_loc = n // size
    return slice(mesh.coords[axis] * n_loc, (mesh.coords[axis] + 1) * n_loc)


def lens_sharding(mesh: Mesh, n_systems: int) -> slice:
    """This rank's systems of a (B, ...) table: systems over 'lens'."""
    return axis_block(mesh, LENS_AXIS, n_systems)


def ray_sharding(mesh: Mesh, n_systems: int, n_pupil: int) -> Tuple[slice, ...]:
    """This rank's block of a (B, F, P, W) ray array: systems over 'lens',
    pupil rays over 'rays'."""
    return (lens_sharding(mesh, n_systems), slice(None), axis_block(mesh, RAY_AXIS, n_pupil),
            slice(None))


def replicated(mesh: Mesh) -> slice:
    """The whole of a replicated array: every rank holds all of it."""
    return slice(None)


def _rank_main(rank, fn, world_size, store, device, args):
    _, rank_device = init_distributed(f"file://{store}", world_size, rank, device=device)
    if rank_device.type == "cpu":
        # The ranks share this host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        fn(rank_device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), device=None) -> None:
    """Run ``fn(device, *args)`` on ``world_size`` new processes, the ranks of
    one process group on this host (``init_distributed`` through a store
    file of its own, so that groups started at once do not meet; the
    backend by its rule, ``device`` as there). ``fn`` must be importable by
    name (the processes start by ``spawn``). A rank that raises ends the
    others and raises here."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, nprocs=world_size, join=True, start_method="spawn",
                           args=(fn, world_size, os.path.join(tmp, "store"), device, args))
