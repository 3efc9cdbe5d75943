"""Data parallelism over torch.distributed (counterpart of
tcresnet_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (data, model) mesh and lets
XLA's global view do the rest: a batch is sharded over `data`, state is
replicated, and the gradient all-reduce and global-batch BatchNorm come
from the shardings. Here every rank is a process with one device, and
the same semantics are spelled out:

  data   the batch axis. Each rank keeps the rows `batch_rows` gives it
         (XLA's layout: blocks of ceil(B / data) rows, so with a batch
         that does not divide, the last ranks hold fewer rows or none, as
         JAX allows). Gradients are summed over it in one flat all-reduce
         a step (`all_reduce_grads`); a training batch norm all-reduces
         its moments' sums, and in its backward their gradients' sums,
         once each a layer (`all_reduce_`, ops/kernels/batchnorm.py).
  model  a replica axis, as in JAX: state is replicated over it and the
         batch is not sharded over it, so ranks with the same data index
         compute the same rows. Collectives run over the data axis only,
         within the ranks of one model index (`Mesh.data_group`).

All state is replicated and stays bit-equal on every rank; the dataset is
replicated on every device (Speech Commands v1 is ~0.8 GB as int16).
Random draws stay global: a `ShardedGenerator` draws the whole batch from
the (seed, step, stream) generator and hands the rank its rows (`draw`),
so N ranks consume exactly the draws of one process and a resumed run
draws what an uninterrupted one would.

Processes. `launch` starts one process per rank with the spawn start
method (the caller may hold a CUDA context, which fork would copy) and a
rendezvous through a file store in a temporary directory, or, under
torchrun (RANK / WORLD_SIZE / LOCAL_RANK in the environment), joins the
group torchrun set up. NCCL serves ranks that each own a card; gloo serves
CPU ranks and ranks that share one card (NCCL refuses two ranks on one
device), its collectives staged through host copies for CUDA tensors.
A rank's failure fails the launch with that rank's traceback, and the
other ranks are killed; no rank ever goes on alone.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tcresnet_tpu_torch.config import MeshConfig

# seconds a collective or the rendezvous may take (torch.distributed's own
# default); a launch given a timeout of its own uses that one
COLLECTIVE_TIMEOUT = 1800.0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def mesh_shape(cfg: Optional[MeshConfig], n_devices: int) -> Tuple[int, int]:
    """(data, model) of `cfg` over `n_devices` devices, with the JAX
    package's rules and messages: an explicit data axis takes exactly
    data * model devices (truncating the list), -1 takes them all and
    needs the model axis to divide their count."""
    cfg = cfg or MeshConfig()
    model = max(cfg.model, 1)
    if cfg.data > 0:
        data = cfg.data
        if data * model > n_devices:
            raise ValueError(f"mesh ({data=}, {model=}) needs {data * model} devices, "
                             f"have {n_devices}")
        return data, model
    if n_devices % model != 0:
        raise ValueError(f"model axis {model} does not divide device count {n_devices}")
    return n_devices // model, model


def visible_devices() -> List[torch.device]:
    """The devices a mesh takes by default: every visible card."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested but CUDA is not available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank owns a card of its own, gloo otherwise (CPU
    ranks, or ranks that share a card)."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and len({d.index for d in cuda}) == len(cuda):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data, model) mesh. Rank r sits at data index
    r // model and model index r % model, on devices[r]."""

    data: int
    model: int
    rank: int
    devices: Tuple[torch.device, ...]
    # the ranks of this rank's model index (None: the default group); None
    # too outside a process group, where a mesh only has a shape
    data_group: Optional[Any] = None
    backend: Optional[str] = None

    @property
    def world_size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def is_chief(self) -> bool:
        """Rank 0, the one rank that writes files and logs at INFO."""
        return self.rank == 0

    @property
    def _staged(self) -> bool:
        # gloo over CUDA tensors (ranks that share a card) goes through
        # host copies; never where each rank owns a card (NCCL)
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The (data, model) mesh of `cfg` over `devices` (default: every
    visible card, `visible_devices`), truncated to data * model of them.

    Inside a process group the group's size must be data * model; the
    mesh then holds this rank and its data-axis group (every rank must
    call make_mesh, since the groups of a model axis > 1 are created
    collectively). Outside one it is rank 0 of a mesh that only has a
    shape (no collective runs on it)."""
    devices = list(devices) if devices is not None else visible_devices()
    data, model = mesh_shape(cfg, len(devices))
    devices = tuple(torch.device(d) for d in devices[: data * model])
    if not dist.is_initialized():
        return Mesh(data, model, 0, devices)
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"mesh (data={data}, model={model}) needs {data * model} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    group = None
    if model > 1:
        for m in range(model):  # every rank creates every group, in one order
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                group = g
    return Mesh(data, model, rank, devices, group, dist.get_backend())


def batch_rows(mesh: Optional[Mesh], batch: int) -> slice:
    """The rows of a global batch of `batch` that this rank keeps: XLA's
    layout of a batch sharded over `data`, blocks of ceil(batch / data)
    rows in data-index order (the last blocks short or empty when the
    batch does not divide). All rows without a mesh."""
    if mesh is None or mesh.data == 1:
        return slice(0, batch)
    block = -(-batch // mesh.data)
    start = min(mesh.data_index * block, batch)
    return slice(start, min(start + block, batch))


# ---------------------------------------------------------------------------
# collectives over the data axis
# ---------------------------------------------------------------------------


def in_group(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` is a rank's view inside a process group: the one
    test of every collective here. Inside a group every collective runs,
    also where the data axis or the world is one rank: the sums are then
    copies, which keeps a one-rank mesh on the code path of N ranks and
    makes what the collectives cost measurable on one card. Outside a
    group (mesh None, or a mesh that only has a shape) none runs."""
    return mesh is not None and mesh.backend is not None


def all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` in place over the data axis; returns it."""
    if not in_group(mesh):
        return t
    if mesh._staged:
        host = t.detach().cpu()
        dist.all_reduce(host, group=mesh.data_group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=mesh.data_group)
    return t


def all_reduce_grads(mesh: Mesh, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum a step's gradients over the data axis in one flat buffer, in
    the order given; the summed tensors, shaped as the inputs."""
    if not in_group(mesh) or not grads:
        return list(grads)
    flat = all_reduce_(mesh, torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_gather_rows(mesh: Mesh, x: torch.Tensor, batch: int) -> torch.Tensor:
    """This rank's rows of a global batch of `batch` (`batch_rows`) ->
    the whole batch in row order, on every rank of the data axis."""
    if not in_group(mesh):
        return x
    block = -(-batch // mesh.data)
    padded = x.new_zeros((block,) + tuple(x.shape[1:]))
    padded[: x.shape[0]] = x
    if mesh._staged:
        padded = padded.cpu()
    parts = [torch.empty_like(padded) for _ in range(mesh.data)]
    dist.all_gather(parts, padded.contiguous(), group=mesh.data_group)
    return torch.cat(parts)[:batch].to(x.device)


def broadcast_object(mesh: Optional[Mesh], obj: Any) -> Any:
    """Rank 0's `obj` on every rank (a host object, pickled)."""
    if not in_group(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_true(mesh: Optional[Mesh], flag: bool) -> bool:
    """Whether `flag` holds on every rank."""
    if not in_group(mesh):
        return flag
    flags = [None] * mesh.world_size
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing outside a process group)."""
    if not in_group(mesh):
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# global draws
# ---------------------------------------------------------------------------


class ShardedGenerator(torch.Generator):
    """A torch.Generator that stands for the draws of a global batch: with
    `rows` set (`keep`), every batch-sized draw made through `draw` draws
    all `total` rows and keeps this rank's, so the values and the
    generator's position after the draw are those of one process drawing
    the whole batch. Without `rows` it is a plain generator."""

    rows: Optional[slice] = None
    total: int = 0

    def keep(self, rows: Optional[slice], total: int = 0) -> "ShardedGenerator":
        self.rows, self.total = rows, total
        return self


def draw(generator: Optional[torch.Generator], fn: Callable[[int], torch.Tensor],
         n: int) -> torch.Tensor:
    """`fn(m)` draws a tensor of m rows from `generator`; this returns the
    `n` rows this process holds: fn(n) from a plain generator, the kept
    rows of fn(total) from a `ShardedGenerator` with rows set."""
    rows = getattr(generator, "rows", None)
    if rows is None:
        return fn(n)
    if rows.stop - rows.start != n:
        raise ValueError(f"a draw of {n} rows from a generator that keeps rows "
                         f"[{rows.start}, {rows.stop}) of {generator.total}")
    return fn(generator.total)[rows]


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def torchrun_rank() -> Optional[Tuple[int, int]]:
    """(rank, world size) when torchrun started this process, else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def _join_group(cfg: MeshConfig, devices: Sequence[torch.device], rank: int, world: int,
                init_method: str, timeout: float) -> Mesh:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(devices), init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return make_mesh(cfg, devices)


def _rank_main(fn, args, cfg, devices, rank, world, store_dir, timeout) -> None:
    """A spawned rank: join the group, run fn(mesh, *args), leave its
    result (or its traceback) in the store directory."""
    try:
        if torch.device(devices[rank]).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh = _join_group(cfg, devices, rank, world,
                           f"file://{os.path.join(store_dir, 'store')}", timeout)
        result = fn(mesh, *args)
        barrier(mesh)
    except BaseException:
        # the traceback is written before anything tears the group down, so
        # that the cause's file is older than its peers' (`_raise_first_failure`)
        with open(os.path.join(store_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)  # a rank stuck in a collective's teardown must not hang the exit
    dist.destroy_process_group()
    tmp = os.path.join(store_dir, f"result_{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(store_dir, f"result_{rank}.pkl"))


def launch(fn: Callable, *args, cfg: Optional[MeshConfig] = None,
           devices: Optional[Sequence[torch.device]] = None,
           timeout: Optional[float] = None,
           collective_timeout: Optional[float] = None) -> List[Any]:
    """Run `fn(mesh, *args)` on every rank of the mesh of `cfg` over
    `devices` (`make_mesh`'s defaults) and return the ranks' results in
    rank order. `fn` and `args` are pickled (fn by its import path) and so
    is each result: return host objects, not CUDA tensors.

    Under torchrun this process is one rank of a group torchrun set up:
    fn runs here and the list holds this rank's result alone. Otherwise
    one process a rank is spawned; if one fails, the others are killed and
    RuntimeError carries its traceback. With `timeout` every rank is killed
    past that many seconds (TimeoutError); without, a launch may run as
    long as it needs. A collective or the rendezvous fails after
    `collective_timeout` seconds (default: `timeout`, else
    COLLECTIVE_TIMEOUT)."""
    devices = list(devices) if devices is not None else visible_devices()
    data, model = mesh_shape(cfg, len(devices))
    world = data * model
    devices = [torch.device(d) for d in devices[:world]]
    cfg = dataclasses.replace(cfg or MeshConfig(), data=data, model=model)
    pg_timeout = collective_timeout or timeout or COLLECTIVE_TIMEOUT

    env = torchrun_rank()
    if env is not None:
        rank, size = env
        if size != world:
            raise ValueError(f"torchrun started {size} ranks, the mesh "
                             f"(data={data}, model={model}) needs {world}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if devices[rank].type == "cuda":
            devices[rank] = torch.device("cuda", local)
        mesh = _join_group(cfg, devices, rank, world, "env://", pg_timeout)
        try:
            result = fn(mesh, *args)
            barrier(mesh)
        finally:
            dist.destroy_process_group()
        return [result]

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tcresnet_mesh_") as store:
        procs = [ctx.Process(target=_rank_main, daemon=True, name=f"rank{r}",
                             args=(fn, args, cfg, devices, r, world, store, pg_timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _wait(procs, store, None if timeout is None else time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        results = []
        for r in range(world):
            with open(os.path.join(store, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by our own ranks
        return results


def _wait(procs, store: str, deadline: Optional[float]) -> None:
    """Until every rank has exited 0; raise on the first failure or at
    the deadline (none when None)."""
    pending = list(procs)
    while pending:
        left = 5.0 if deadline is None else deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"ranks {[p.name for p in pending]} still running at the "
                               "launch's timeout")
        multiprocessing.connection.wait([p.sentinel for p in pending], timeout=min(left, 5.0))
        for p in list(pending):
            if p.exitcode is None:
                continue
            pending.remove(p)
            if p.exitcode != 0:
                _raise_first_failure(procs, store, procs.index(p))


def _raise_first_failure(procs, store: str, exited: int) -> None:
    """RuntimeError with the traceback of the rank that failed first: a
    rank's failure breaks its peers' collectives, and they fail after it,
    so the earliest traceback written is the cause."""
    errors = []
    for rank in range(len(procs)):
        path = os.path.join(store, f"error_{rank}.txt")
        if os.path.exists(path):
            errors.append((os.stat(path).st_mtime_ns, rank, path))
    if not errors:
        raise RuntimeError(f"rank {exited} died (exit code {procs[exited].exitcode}) "
                           "before it could write a traceback")
    _, rank, path = min(errors)
    with open(path) as f:
        tb = f.read()
    raise RuntimeError(f"rank {rank} failed (exit code {procs[rank].exitcode}):\n{tb}")
