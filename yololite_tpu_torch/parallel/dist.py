"""Data and spatial parallelism over processes, one per GPU (port of
`parallel/mesh.py`'s `data` and `spatial` axes).

The JAX package shards the batch dim over a mesh axis "data", replicates
parameters and optimizer state, and lets XLA insert the gradient
all-reduce; every batch reduction of the one program (BatchNorm's batch
statistics, the fake-quant activation scale, the device augmentation's
draws, the logged metrics) spans the global batch. Here each process holds
a replica and its rows of the batch, and the library collectives of
`torch.distributed` (NCCL on the card, gloo on the CPU) stand in for XLA's:

  - `init_distributed` joins (or, with torchrun's environment, reads) the
    process group and selects this process's card;
  - `DataParallel` says which rows of a batch are this process's:
    `batch_rows` of the node's batch (the train loader's), `world_rows` of
    a batch spread over every process (validation, device augmentation);
  - `all_reduce_` sums in place: BatchNorm's statistics in its forward and
    the sums its input gradient needs in its backward
    (`models/layers.BatchNorm`); `all_reduce_sum` is an autograd function
    whose backward all-reduces the gradient (the spatial axis's global
    pools);
  - `all_reduce_grads` sums the parameter gradients in a few fp32 buckets,
    `all_reduce_max` gives the global fake-quant scale, `broadcast_state`
    makes every replica rank 0's, and `gather_objects` /
    `broadcast_object` move host objects (detections, COCO stats) over a
    gloo group made once;
  - `spawn` runs a function in N spawned processes and returns what each
    returned (the loop's `data_parallel: N`, the tests' ranks).

`active(dp)` marks the forwards whose batch reductions must be global (the
Trainer's train and eval forwards); outside it, and at world size 1, the
layers compute what they always did. Every collective call is counted in
`CALLS` (the halo and gather all-gathers of `parallel/spatial.py` with the
bytes each rank received).

The mesh: `world = n_data x n_spatial` processes, rank r at
`(d, s) = divmod(r, n_spatial)`, as `make_mesh` lays devices out by
`reshape(n_data, n_spatial)`. The `n_spatial` ranks of one data index hold
the same batch rows (`batch_rows`, `world_rows` are the data index's) and
split the image height (`parallel/spatial.py`); `mesh_groups` gives this
rank's spatial group (its data index's ranks) and data group (its spatial
index's ranks). The collectives take a group: BatchNorm's statistics, the
fake-quant scale and the gradients span every rank (the default group),
global pools the spatial group, the logged metrics the data group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

# collective calls by kind since the last reset (what one step makes)
CALLS: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "gather_object": 0,
                         "halo": 0, "halo_bytes": 0, "gather": 0, "gather_bytes": 0}
# gradient bucket size (one all-reduce each)
BUCKET_BYTES = 25 * 2**20

_ACTIVE: Optional["DataParallel"] = None
_OBJECT_GROUP = None
# n_spatial -> (spatial group of each data index, data group of each spatial index)
_MESH_GROUPS: Dict[int, tuple] = {}


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place: `world` processes, `local_world` of them on each
    node (host), JAX's `process_index`/`process_count` being the node's;
    `n_spatial` consecutive ranks (on one node) split each image's height."""

    world: int
    rank: int
    local_rank: int
    local_world: int
    n_spatial: int = 1

    @property
    def node_rank(self) -> int:
        return self.rank // self.local_world

    @property
    def node_count(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    def batch_rows(self, global_b: int) -> slice:
        """This rank's rows of a node's batch of `global_b` images (its data
        index's on the node)."""
        return _rows(global_b, self.local_rank // self.n_spatial,
                     self.local_world // self.n_spatial)

    def world_rows(self, global_b: int) -> slice:
        """This rank's rows of a batch of `global_b` images spread over every
        data index (node after node)."""
        return _rows(global_b, self.data_index, self.n_data)

    @classmethod
    def from_group(cls, n_spatial: int = 1) -> "DataParallel":
        """The initialized default group; the local size from torchrun's
        LOCAL_WORLD_SIZE, else every process is on this node."""
        world, rank = dist.get_world_size(), dist.get_rank()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local_world:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"LOCAL_WORLD_SIZE {local_world}")
        if local_world % n_spatial:
            raise ValueError(f"spatial_parallel {n_spatial} does not divide the "
                             f"{local_world} processes of a node")
        local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
        return cls(world, rank, local_rank, local_world, n_spatial)


def mesh_groups(dp: DataParallel) -> tuple:
    """(spatial group, data group) of this rank: the processes of its data
    index, and of its spatial index (None: the default group, which the data
    axis spans alone at n_spatial 1). Every rank makes every group of its
    layout on the first call, in one order, as `new_group` requires."""
    if dp.n_spatial == 1:
        return None, None
    n, n_data = dp.n_spatial, dp.n_data
    if n not in _MESH_GROUPS:
        _MESH_GROUPS[n] = ([dist.new_group([d * n + s for s in range(n)]) for d in range(n_data)],
                           [dist.new_group([d * n + s for d in range(n_data)]) for s in range(n)])
    spatial, data = _MESH_GROUPS[n]
    return spatial[dp.data_index], data[dp.spatial_index]


def _rows(n: int, index: int, count: int) -> slice:
    if n % count:
        raise ValueError(f"a batch of {n} does not split over {count} processes")
    per = n // count
    return slice(index * per, (index + 1) * per)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join the process group (mesh.py's `init_distributed`); returns the
    world size. Unset arguments come from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT). The backend is NCCL when CUDA is
    present and gloo otherwise, unless named; with CUDA this process's card
    is LOCAL_RANK's."""
    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs: Dict[str, Any] = {"backend": backend}
    if coordinator_address:
        addr = coordinator_address
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if torch.cuda.is_available() and backend == "nccl":
        rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", torch.cuda.device_count()))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % local_world)))
    dist.init_process_group(**kwargs)
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (and drop the object group made over it)."""
    global _OBJECT_GROUP
    _OBJECT_GROUP = None
    _MESH_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess(dp: Optional[DataParallel]) -> bool:
    """Does `dp` span more than one process?"""
    return dp is not None and dp.world > 1


def current() -> Optional[DataParallel]:
    """The context of the forward being run (`active`), or None."""
    return _ACTIVE


@contextlib.contextmanager
def active(dp: Optional[DataParallel]) -> Iterator[None]:
    """Batch reductions inside are global over `dp` (nothing at world 1)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (dp if is_multiprocess(dp) else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    CALLS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's processes of x; the backward sums the
    gradient of y over them too (each process's loss depends on every
    process's x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over the processes of `group` (None: all)."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over processes, in place (no gradient)."""
    return _all_reduce(x, group=group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over processes (a new tensor; no gradient)."""
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX, group)


@torch.no_grad()
def all_gather(t: torch.Tensor, group, kind: str) -> List[torch.Tensor]:
    """Every process's `t` (one shape on all), in the group's rank order; a
    CUDA tensor on a gloo group travels through host memory. Counted in
    `CALLS[kind]`, and the bytes received from the others in
    `CALLS[kind + "_bytes"]`."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    CALLS[kind] += 1
    CALLS[kind + "_bytes"] += (n - 1) * src.numel() * src.element_size()
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Indices of `tensors` in runs of one dtype and device and at most
    BUCKET_BYTES (a larger tensor alone)."""
    run: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        if run and (size + nb > BUCKET_BYTES or (t.dtype, t.device) !=
                    (tensors[run[0]].dtype, tensors[run[0]].device)):
            yield run
            run, size = [], 0
        run.append(i)
        size += nb
    if run:
        yield run


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum fp32 gradients over processes, one all-reduce a bucket; in place,
    returned for convenience."""
    grads = list(grads)
    for run in _buckets(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in run])
        _all_reduce(flat)
        for i, part in zip(run, flat.split([grads[i].numel() for i in run])):
            grads[i].copy_(part.view_as(grads[i]))
    return grads


@torch.no_grad()
def _broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` with rank 0's, one broadcast a bucket."""
    tensors = list(tensors)
    for run in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        CALLS["broadcast"] += 1
        dist.broadcast(flat, src=0)
        for i, part in zip(run, flat.split([tensors[i].numel() for i in run])):
            tensors[i].copy_(part.view_as(tensors[i]))


def broadcast_state(modules: Sequence[torch.nn.Module],
                    extra: Sequence[torch.Tensor] = ()) -> None:
    """Make parameters and buffers of `modules` (the model, its EMA copy) and
    the `extra` tensors (optimizer moments, accumulators) rank 0's."""
    tensors = [t for m in modules for t in m.state_dict().values()] + list(extra)
    _broadcast_tensors(tensors)


def _object_group():
    """A gloo group over every process, made once (host objects do not go
    through NCCL); the default group when it is gloo already."""
    global _OBJECT_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _OBJECT_GROUP is None:
        _OBJECT_GROUP = dist.new_group(backend="gloo")
    return _OBJECT_GROUP


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Every process's `obj`, in rank order, on rank 0; None elsewhere."""
    group = _object_group()
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    CALLS["gather_object"] += 1
    dist.gather_object(obj, out, dst=0, group=group)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every process."""
    box = [obj]
    CALLS["broadcast"] += 1
    dist.broadcast_object_list(box, src=0, group=_object_group())
    return box[0]


def barrier() -> None:
    dist.barrier(group=_object_group())


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def free_port() -> int:
    """A free TCP port on localhost, for a group's `localhost:<port>`."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn: Callable[..., Any], args: tuple, out_dir: str) -> None:
    result = fn(rank, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable[..., Any], args: tuple, nprocs: int,
          timeout: Optional[float] = None) -> List[Any]:
    """`fn(rank, *args)` in `nprocs` spawned processes; their return values
    in rank order. A process that raises raises here; with `timeout`
    (seconds), processes still running then are killed and TimeoutError
    raised."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_spawned, args=(fn, args, out_dir), nprocs=nprocs,
                                 join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{nprocs} processes did not finish in {timeout} s")
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
