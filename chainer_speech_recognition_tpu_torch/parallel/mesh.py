"""Data-parallel ranks and their mesh (port of ``parallel/mesh.py``).

The reference shards a batch over a JAX mesh inside ``shard_map``; the
port runs PyTorch's own idiom instead: one process a card (a rank), an
NCCL process group over the cards and a gloo group on the CPU for host
objects and barriers (on the CPU, gloo is both). Each rank holds the
whole replicated state, trains on its contiguous segment of every global
batch and sums its gradients with the others' by an explicit all-reduce
inside the step body (``train/step.py``), so a CUDA graph of K steps
captures the collective too.

``make_mesh`` gives the rank's view of the world: rank, size, local
device, the groups. ``parallel.dcn_slices > 1`` makes it a 2-D
``(dcn, data)`` mesh (``init_device_mesh``): the rows of a batch split over
both axes in rank order, and every reduction covers both (the data axis
first, then the dcn axis), so on one node it is the 1-D mesh with another
summation order.

The rest are the counterparts of the reference's sharding helpers: the
rank's row segment of a ``[B]`` batch (``row_segment``, ``shard_batch``)
and of axis 1 of a ``[K, B]`` slot matrix (``dispatch_rows``), the sum
over ranks (``all_reduce_``), the gather that restores the global row
order (``all_gather_rows``), and ``launch``, which starts the ranks of a
CLI.

    python -m chainer_speech_recognition_tpu_torch.cli.train \\
        --data-dir prep --preset bigru --set parallel.num_devices=4
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import ParallelConfig


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel world. ``group`` is None for a
    process that runs alone (no process group); ``axis_groups`` holds the
    rank's group along each axis of a 2-D mesh, else the one group."""

    rank: int
    size: int
    device: torch.device
    shape: tuple
    axis_names: tuple
    group: object = None
    cpu_group: object = None
    axis_groups: tuple = ()

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_writer(self) -> bool:
        """The rank that writes logs, metrics, checkpoints and stdout."""
        return self.rank == 0


def make_mesh(cfg: ParallelConfig, device) -> Mesh:
    """The mesh of the process group this process belongs to (none: a
    mesh of one). ``cfg.num_devices`` 0 takes every rank of the group;
    more devices than the group has raise, as do fewer (a rank outside
    the mesh would have no rows), and so does a ``dcn_slices`` that does
    not divide them."""
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = cfg.num_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n < world:
        raise ValueError(
            f"parallel.num_devices={n} but the process group has {world} "
            "ranks: the port runs one rank a device (set it to 0 or "
            f"{world})")
    if cfg.dcn_slices > 1 and n % cfg.dcn_slices:
        raise ValueError(
            f"{n} devices do not split into {cfg.dcn_slices} dcn slices: "
            "the 2-D mesh of data parallelism needs parallel.dcn_slices "
            "to divide the devices")
    if not dist.is_initialized():
        return Mesh(rank=0, size=1, device=device, shape=(1,),
                    axis_names=(cfg.data_axis,))
    rank = dist.get_rank()
    group = dist.group.WORLD
    # host objects and barriers: gloo (a new group over the NCCL world's
    # ranks; every rank makes its mesh at the same point)
    cpu_group = (group if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
    if cfg.dcn_slices > 1:
        from torch.distributed.device_mesh import init_device_mesh

        shape = (cfg.dcn_slices, n // cfg.dcn_slices)
        names = (cfg.dcn_axis, cfg.data_axis)
        dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
        # the inner (data) axis first: the slice-local partial sums, then
        # the slices' partials across the dcn axis
        groups = (dm.get_group(cfg.data_axis), dm.get_group(cfg.dcn_axis))
        return Mesh(rank, n, device, shape, names, group, cpu_group, groups)
    return Mesh(rank, n, device, (n,), (cfg.data_axis,), group, cpu_group,
                (group,))


def row_segment(mesh: Mesh | None, B: int) -> slice:
    """This rank's contiguous rows of a batch of ``B`` (rank order is the
    mesh's row-major order)."""
    if mesh is None or mesh.size == 1:
        return slice(0, B)
    if B % mesh.size:
        raise ValueError(f"batch of {B} rows does not split over "
                         f"{mesh.size} devices")
    k = B // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh | None, batch: dict) -> dict:
    """This rank's rows of every array of a host or device batch (other
    values, such as ``bucket_id``, pass through)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v):
            out[k] = v[row_segment(mesh, v.shape[0])]
        else:
            out[k] = v
    return out


def dispatch_rows(mesh: Mesh | None, slots):
    """This rank's slot ids of a dispatch: [B] splits axis 0, [K, B] axis
    1 (K is time, not data), as the reference's ``dispatch_sharding``."""
    if np.ndim(slots) == 1:
        return slots[row_segment(mesh, slots.shape[0])]
    return slots[:, row_segment(mesh, slots.shape[1])]


def all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank in place (each axis of a 2-D mesh in
    turn); on the card inside a graph capture too (NCCL)."""
    if not mesh.distributed:
        return t
    for g in mesh.axis_groups:
        dist.all_reduce(t, group=g)
    return t


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along axis
    0 in rank order: the global row order of a sharded batch."""
    if not mesh.distributed or mesh.size == 1:
        return t
    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, 0)


def broadcast_(mesh: Mesh, tensors) -> None:
    """Overwrite every rank's ``tensors`` with rank 0's, in place."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, 0, group=mesh.group)


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (host values)."""
    if not mesh.distributed:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.cpu_group)
    return bool(t.item())


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.cpu_group)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def _spawned(rank: int, world: int, init: str, device, main, args) -> None:
    device = _rank_device(torch.device(device), rank)
    dist.init_process_group(_backend(device), init_method=init,
                            world_size=world, rank=rank)
    try:
        main(device, *args)
    finally:
        dist.destroy_process_group()


def launch(main, n: int, device, *args) -> None:
    """Run ``main(device, *args)`` on every rank of the data-parallel
    world, each rank with its own device:

    * inside a process group the caller made, in this process;
    * under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
      the rendezvous in the environment), in this process as that rank,
      after joining the group (NCCL on the card, gloo on the CPU);
    * else, with ``n`` > 1, on ``n`` new processes (one card each, or
      the CPU), whose group meets through a file in a temporary
      directory; else in this process, alone.

    On the card ``n`` may not exceed the visible cards. A failure of the
    group raises: nothing falls back to fewer ranks."""
    device = torch.device(device)
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        main(_rank_device(device, local) if device.index is None
             else device, *args)
        return
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        device = _rank_device(device, int(env.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend(device), init_method="env://")
        try:
            main(device, *args)
        finally:
            dist.destroy_process_group()
        return
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"requested {n} devices, have "
                         f"{torch.cuda.device_count()}")
    if n <= 1:
        main(device, *args)
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="csr-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_spawned, args=(n, init, str(device), main, args),
                 nprocs=n, join=True)


def visible_devices(device) -> int:
    """``parallel.num_devices`` 0: every visible card; one process on the
    CPU."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1
