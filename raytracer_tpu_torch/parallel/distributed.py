"""Several processes: torch.distributed plumbing, the 1-D mesh of ranks,
and the only communication the port does.

Port of raytracer_tpu/parallel/distributed.py. Each process is one rank.
It calls `init_from_env()` before it builds a scene; `global_mesh()` (or
parallel/sharding.make_mesh) then gives the 1-D 'rays' mesh over the
first n ranks, which every multi-rank entry point of parallel/sharding.py
takes as `mesh`.

Environment (set by the launcher, such as parallel/worker.launch):
  RT_COORDINATOR     host:port of rank 0 (a tcp:// store), unless the
                     caller passes init_method= (a file:// store in tests)
  RT_NUM_PROCESSES   the rank count
  RT_PROCESS_ID      this rank (0-based)
  RT_CPU_DEVICES     set (to 1): gloo ranks on the CPU
  RT_BACKEND         'nccl' (the default): one rank per card; 'gloo':
                     several ranks on one card, rank r on card
                     r % device_count

Three setups, each chosen by these variables and never by catching a
failure: gloo ranks on the CPU, gloo ranks sharing cards, and NCCL with one
rank per card (more NCCL ranks than cards raise).

`all_reduce_sum`, `all_gather_rows` and `ring_shift` are the port's three
collectives. Each decides by the group's backend whether its tensors go
through host memory: gloo reads only host memory in send and recv, so a
CUDA tensor is copied to the host, moved, and copied back to its card;
NCCL moves CUDA tensors as they are. `any_true` is the one shared host
decision (an all_reduce MAX of a flag). `STATS` counts their calls, bytes
and walls; a wall on the card is taken between two device syncs, so it
holds no compute.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import ClassVar

import numpy as np
import torch
import torch.distributed as dist

AXIS = 'rays'
# a collective that waits longer raises
TIMEOUT_S = 600

# calls, bytes moved by this rank and walls in seconds, per collective
STATS = {k: 0 for k in ('hops', 'hop_bytes', 'hop_s', 'reduces',
                        'reduce_bytes', 'reduce_s', 'gathers',
                        'gather_bytes', 'gather_s', 'flags')}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def backend_from_env() -> str:
    """'gloo' for RT_CPU_DEVICES or RT_BACKEND=gloo, else 'nccl'."""
    if os.environ.get('RT_CPU_DEVICES'):
        if os.environ.get('RT_BACKEND', 'gloo') != 'gloo':
            raise ValueError('RT_CPU_DEVICES puts the ranks on the CPU, '
                             'where only the gloo backend runs')
        return 'gloo'
    backend = os.environ.get('RT_BACKEND', 'nccl')
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'RT_BACKEND={backend!r}: nccl or gloo')
    return backend


def device() -> torch.device:
    """This rank's device: the CPU under RT_CPU_DEVICES, else card
    rank % device_count."""
    if os.environ.get('RT_CPU_DEVICES'):
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: set RT_CPU_DEVICES=1 for gloo '
                           'ranks on the CPU')
    rank = int(os.environ.get('RT_PROCESS_ID', '0'))
    return torch.device('cuda', rank % torch.cuda.device_count())


def init_from_env(init_method: str | None = None) -> bool:
    """Join the process group that the RT_* variables describe -> True;
    False (nothing done) when neither RT_COORDINATOR nor init_method is
    given. A collective that waits longer than TIMEOUT_S raises."""
    coord = os.environ.get('RT_COORDINATOR')
    if init_method is None:
        if not coord:
            return False
        init_method = f'tcp://{coord}'
    world = int(os.environ['RT_NUM_PROCESSES'])
    rank = int(os.environ['RT_PROCESS_ID'])
    backend = backend_from_env()
    dev = device()
    if backend == 'nccl' and world > torch.cuda.device_count():
        raise RuntimeError(
            f'NCCL takes one card a rank: {world} ranks, '
            f'{torch.cuda.device_count()} cards (set RT_BACKEND=gloo to put '
            f'several ranks on one card)')
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh (axis 'rays') over the global ranks `ranks`, with its
    process group (None: the world's)."""
    ranks: tuple
    group: object = None
    axis: ClassVar[str] = AXIS

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's index in the mesh."""
        me = dist.get_rank()
        if me not in self.ranks:
            raise RuntimeError(f'rank {me} is not in the mesh {self.ranks}')
        return self.ranks.index(me)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def global_mesh(n: int | None = None) -> Mesh:
    """The mesh over the first n ranks of the world (all by default). Every
    rank of the world must call it (a smaller mesh makes a new group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            'no process group: every rank calls '
            'parallel.distributed.init_from_env() (RT_NUM_PROCESSES, '
            'RT_PROCESS_ID, RT_COORDINATOR) before make_mesh / global_mesh')
    world = dist.get_world_size()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f'a mesh of {n} ranks in a world of {world}')
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(tuple(range(n)), group)


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f'mesh: expected a parallel.distributed.Mesh '
                        f'(sharding.make_mesh), got {type(mesh).__name__}')
    return mesh


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def gather_image(img) -> np.ndarray | None:
    """The full image (render_sharded already gathered it on every rank)
    as numpy on rank 0; None on the others."""
    return img.detach().cpu().numpy() if process_info()[0] == 0 else None


def _sync(x) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _staged(x, mesh: Mesh):
    """x as the group's backend moves it: on the host under gloo."""
    return x.cpu() if mesh.backend == 'gloo' else x


def all_reduce_sum(tensors: list, mesh: Mesh) -> list:
    """Each float32 tensor summed over the mesh's ranks, in one
    all_reduce of their concatenation -> new tensors of the same shapes."""
    dev = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _sync(flat)
    t0 = time.perf_counter()
    buf = _staged(flat, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    buf = buf.to(dev)
    _sync(buf)
    STATS['reduces'] += 1
    STATS['reduce_bytes'] += flat.numel() * flat.element_size()
    STATS['reduce_s'] += time.perf_counter() - t0
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def all_gather_rows(x, mesh: Mesh):
    """(n, ...) rows of every rank, equal n, concatenated in mesh order ->
    (size * n, ...) on x's device."""
    x = x.detach().contiguous()
    _sync(x)
    t0 = time.perf_counter()
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    out = torch.cat(parts).to(x.device)
    _sync(out)
    STATS['gathers'] += 1
    STATS['gather_bytes'] += x.numel() * x.element_size()
    STATS['gather_s'] += time.perf_counter() - t0
    return out


def ring_shift(tensors: list, mesh: Mesh) -> list:
    """Send 4-byte tensors (float32, int32) to the next rank of the ring,
    (r + 1) % size, and receive the previous rank's tensors of the same
    shapes and types, as one message each way."""
    if mesh.size == 1:
        return list(tensors)
    for t in tensors:
        if t.element_size() != 4:
            raise ValueError(f'ring_shift moves 4-byte tensors, not {t.dtype}')
    dev = tensors[0].device
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.int32)
                      for t in tensors])
    _sync(flat)
    t0 = time.perf_counter()
    send = _staged(flat, mesh)
    recv = torch.empty_like(send)
    r, D = mesh.rank, mesh.size
    ops = [dist.P2POp(dist.isend, send, mesh.ranks[(r + 1) % D], mesh.group),
           dist.P2POp(dist.irecv, recv, mesh.ranks[(r - 1) % D], mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    recv = recv.to(dev)
    _sync(recv)
    STATS['hops'] += 1
    STATS['hop_bytes'] += flat.numel() * 4
    STATS['hop_s'] += time.perf_counter() - t0
    out, at = [], 0
    for t in tensors:
        out.append(recv[at:at + t.numel()].view(t.dtype).reshape(t.shape))
        at += t.numel()
    return out


def any_true(x, mesh: Mesh) -> bool:
    """x.any() over all the mesh's ranks (one all_reduce MAX), so that
    every rank takes the same branch."""
    buf = _staged(x.any().to(torch.int32).reshape(1), mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    STATS['flags'] += 1
    return bool(buf.item())
