"""Multi-process execution helpers (port of ``qpsk_tpu.parallel.multihost``).

The JAX package runs every device of a mesh from one process: its shards
are the bodies of a ``shard_map`` and XLA owns the transport.  PyTorch
runs one process a card, wired by ``torch.distributed``; the scale-out
modules (this one, ``channels`` and ``stream``) share these conventions:

* **The mesh.**  ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``,
  the counterpart of the JAX ``Mesh``.  The axis names are JAX's: ``"dp"``
  means channels and ``"sp"`` time blocks.  ``axis`` selects the process
  group (``mesh.get_group(axis)``) and this rank's coordinate on it.
* **Inputs and outputs.**  Inputs have the global shapes of the JAX
  signatures, and every rank holds the same input (built from a seed).
  Each rank computes its own block and returns it, as a ``shard_map``
  body does: a rank sees local outputs (gather them with
  ``dist.all_gather_into_tensor``).
* **Devices.**  Every tensor a rank touches is on that rank's card,
  ``cuda:<local rank>``, unless the group runs on the CPU.
* **Backends.**  NCCL on the card, gloo on the CPU.  There is no hidden
  fallback: on the card there is no gloo and no exchange staged through
  host memory, and whatever fails (the group's start, a point-to-point
  operation, a kernel) raises.

Typical use, one process a card under ``torchrun --nproc-per-node=<cards>``:

    from qpsk_tpu_torch.parallel import multihost
    multihost.initialize()                      # torchrun's environment
    mesh = multihost.global_mesh(("dp", "sp"), (world // 2, 2))

Without ``torchrun`` each process passes the JAX arguments:
``initialize("host:port", nprocs, rank)`` (or a ``file://`` store path as
the address).  A single process needs nothing: ``global_mesh`` then starts
a one-rank group of its own.  NCCL puts one rank on a card, so a machine
with one card runs world size 1.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from qpsk_tpu_torch.state import tree_map

__all__ = ["initialize", "global_mesh", "replicate", "aggregate_metrics"]


def _card(local_rank: int) -> torch.device:
    """``cuda:<local_rank>``, bound as this process's current card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "group")
    card = torch.device("cuda", local_rank)
    torch.cuda.set_device(card)
    return card


def _start(device, **kw) -> None:
    """``init_process_group`` on NCCL bound to this rank's card (``device``
    a CUDA device), or on gloo for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Start this process's group: ``init_process_group`` with JAX's three
    arguments as a ``tcp://`` address (an address with a scheme, such as
    ``file:///path/store``, is passed as it is), the world size and the
    rank.  With none of them, the settings come from ``torchrun``'s
    environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); outside any such environment, or when a group is
    already up, it does nothing.

    ``device="cuda"`` binds the rank to its card, ``cuda:<LOCAL_RANK>``
    (without ``LOCAL_RANK``, the rank modulo the visible cards), before
    the group's first collective and starts NCCL; ``"cpu"`` starts gloo.
    """
    if dist.is_initialized():
        return
    args = (coordinator_address, num_processes, process_id)
    env_driven = bool(os.environ.get("MASTER_ADDR")
                      and os.environ.get("WORLD_SIZE"))
    if all(a is None for a in args):
        if not env_driven:
            return  # a single process: nothing to do
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(a is None for a in args):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together, or none of them")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    if torch.device(device).type == "cuda":
        device = _card(int(os.environ.get(
            "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    _start(device, init_method=init_method, world_size=world, rank=rank)


def ensure_group(device) -> None:
    """A one-rank group on an in-memory store when no group is up (the
    JAX package's single-process mesh needs no runtime at all)."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = _card(torch.cuda.current_device() if dev.index is None
                    else dev.index)
    _start(dev, store=dist.HashStore(), rank=0, world_size=1)


def mesh_type() -> str:
    """The device type of the meshes of this process's group: "cuda" on
    NCCL, "cpu" on gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(axis_names: tuple[str, ...],
                axis_sizes: tuple[int, ...] | None = None,
                device=None) -> DeviceMesh:
    """Mesh over every rank of the group.  Defaults to one axis over all
    ranks; with two axes the convention is ("dp", "sp") = (channels,
    time blocks).  Raises ValueError when the sizes do not multiply to the
    world size.  With no group up, it starts a one-rank group on
    ``device`` (the card when None).  ``device=None`` takes the running
    group's device type; a ``device`` of another type than the group's
    (a gloo group asked for the card, NCCL for the CPU) raises ValueError
    rather than moving the work."""
    ensure_group("cuda" if device is None else device)
    if device is not None and torch.device(device).type != mesh_type():
        raise ValueError(f"a {dist.get_backend()} group cannot hold a mesh "
                         f"on {torch.device(device)}")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for a multi-axis mesh")
        axis_sizes = (world,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names) or math.prod(axis_sizes) != world:
        raise ValueError(f"mesh of sizes {axis_sizes} over axes {axis_names} "
                         f"for a world of {world} ranks")
    return init_device_mesh(mesh_type(), axis_sizes, mesh_dim_names=axis_names)


def _card_rank(rank: int, world: int, store: str, fn, args) -> None:
    initialize(f"file://{store}", world, rank, device="cuda")
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_per_card(fn, store: str, *args) -> int:
    """Run ``fn(rank, world, *args)`` in one process a visible card, each
    rank bound to card ``rank`` in an NCCL group on a ``FileStore`` at
    ``store`` (a path in a fresh temporary directory), and the group
    destroyed after.  ``fn`` is a module-level function; it leaves its
    results in files.  Raises if a rank fails.  Returns the world size."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    if world < 1:
        raise RuntimeError("no CUDA device to spawn ranks on")
    mp.spawn(_card_rank, args=(world, store, fn, args), nprocs=world)
    return world


@contextlib.contextmanager
def first_ranks_mesh(n: int, axis: str):
    """A one-axis mesh over the group's first ``n`` ranks for the block
    (every rank of the group must enter it; the others get a mesh they
    are not on).  On leaving, its ranks destroy its process group: on the
    card that group's NCCL communicator is split from the world's, and a
    split communicator left for ``destroy_process_group()`` hangs it."""
    mesh = DeviceMesh(mesh_type(), list(range(n)), mesh_dim_names=(axis,))
    try:
        yield mesh
    finally:
        if dist.get_rank() < n < dist.get_world_size():
            dist.destroy_process_group(mesh.get_group(axis))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its bound card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def to_mesh(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` on this rank's device of ``mesh``.  A tensor on the card
    given to a CPU (gloo) mesh raises ValueError: the work never moves
    off the card unasked."""
    dev = mesh_device(mesh)
    if x.device.type == "cuda" and dev.type != "cuda":
        raise ValueError(f"a tensor on {x.device} given to a "
                         f"{mesh.device_type} mesh: start the group on the "
                         f"card (NCCL) to run there")
    return x.to(dev)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` broadcast from the mesh's first rank, on
    each rank's device (the JAX package's fully replicated placement)."""
    ranks = mesh.mesh.flatten().tolist()
    if mesh.ndim == 1:
        group = mesh.get_group()
    elif len(ranks) == dist.get_world_size():
        group = None
    else:
        raise ValueError("replicate takes a one-axis mesh or one over "
                         "every rank")
    dev = mesh_device(mesh)

    def leaf(x):
        if not torch.is_tensor(x):
            return x
        y = x.detach().to(dev).contiguous().clone()
        dist.broadcast(y, src=ranks[0], group=group)
        return y
    return tree_map(leaf, tree)


def aggregate_metrics(mesh: DeviceMesh, axis: str):
    """A mean reducer for per-shard metric trees (BER, PER, EVM): each
    leaf, this rank's values on its leading per-shard axis, is averaged
    over that axis, summed over ``axis`` with ``all_reduce`` and divided
    by the axis size.  Every rank gets the result."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    dev = mesh_device(mesh)

    def agg(tree):
        def leaf(x):
            m = torch.as_tensor(x, device=dev).to(torch.float32).mean(dim=0)
            dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
            return m / n
        return tree_map(leaf, tree)
    return agg
