"""SPMD processes for the model axis: the process group and its backend.

A mesh with a model axis over 1 runs as one process a device
(``launch.mesh.make_test_mesh`` and ``make_mesh`` over the world of an
initialised process group), each placing its shard of every tensor
with ``torch.distributed.tensor`` (DTensor). ``init_spmd`` starts a
rank's process group from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from explicit
arguments, and picks its backend:

  * ranks on distinct cards: NCCL;
  * more ranks than cards (ranks share a card; NCCL refuses two ranks
    on one GPU): ``"repro_gloo"``, the backend defined here;
  * the CPU: gloo.

``"repro_gloo"`` (``HostStagedGloo``) is gloo over host copies: every
collective copies its CUDA tensors to host memory, runs gloo's CPU
collective, and copies the result back into the CUDA tensors; the
step's compute stays on the card. It needs only gloo's CPU
``allreduce``, ``allgather``, ``broadcast`` and ``barrier``: the
all-gather into one tensor is gloo's list all-gather, the
reduce-scatter an all-reduce followed by the rank's slice, the
all-to-all an all-gather of the inputs followed by the rank's chunks.
Each call is synchronous (its Work is complete when returned), and
``COMM`` counts the calls, the bytes staged and the host seconds spent
in them (the communication share of a step).
"""
from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, rank_device

BACKEND = "repro_gloo"


@dataclasses.dataclass
class CommStats:
    """Collectives run by ``HostStagedGloo`` in this process."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


COMM = CommStats()


def _done(result=None):
    fut = torch.futures.Future()
    fut.set_result(result)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _reduce(opts):
    """(the gloo reduction, whether to divide by the world after it):
    gloo has no average, so it is a sum divided."""
    op = getattr(opts, "reduceOp", None) or dist.ReduceOp.SUM
    if op == dist.ReduceOp.AVG:
        return dist.ReduceOp.SUM, True
    return op, False


class HostStagedGloo(dist.ProcessGroup):
    """A process group whose collectives run gloo's CPU collectives on
    host copies of their tensors (see the module's docstring)."""

    def __init__(self, store, rank: int, world_size: int,
                 timeout: timedelta):
        super().__init__(rank, world_size)
        self._rank, self._world = rank, world_size
        self._gloo = dist.ProcessGroupGloo(store, rank, world_size, timeout)

    # -- staging ---------------------------------------------------------
    def _run(self, tensors: List[torch.Tensor], fn, write_back=None) -> None:
        """Copy ``tensors`` to the host, run ``fn`` on the copies (it
        may write them), copy those ``write_back`` names (all by
        default) back where they came from."""
        t0 = time.perf_counter()
        host = [t.detach().to("cpu", copy=True).contiguous()
                for t in tensors]
        fn(host)
        for i in range(len(tensors)) if write_back is None else write_back:
            tensors[i].copy_(host[i])
        COMM.calls += 1
        COMM.bytes += sum(t.numel() * t.element_size() for t in tensors)
        COMM.seconds += time.perf_counter() - t0

    def _allreduce_host(self, opts):
        op, divide = _reduce(opts)

        def fn(host: List[torch.Tensor]) -> None:
            ao = dist.AllreduceOptions()
            ao.reduceOp = op
            self._gloo.allreduce(host, ao).wait()
            if divide:
                for h in host:
                    h.div_(self._world)
        return fn

    # -- the collectives -------------------------------------------------
    def allreduce(self, tensors, opts=None):
        self._run(list(tensors), self._allreduce_host(opts))
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def broadcast(self, tensors, opts=None):
        root = getattr(opts, "rootRank", 0)

        def fn(host):
            bo = dist.BroadcastOptions()
            bo.rootRank = root
            self._gloo.broadcast(host, bo).wait()
        self._run(list(tensors), fn)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _done()

    def allgather(self, output_tensors, input_tensors, opts=None):
        """``output_tensors[i][r]`` <- rank r's ``input_tensors[i]``."""
        for outs, inp in zip(output_tensors, input_tensors):
            flat = list(outs) + [inp]

            def fn(host, n=len(outs)):
                self._gloo.allgather([host[:n]], [host[n]]).wait()
            self._run(flat, fn, write_back=range(len(outs)))
        return _done(output_tensors)

    def all_gather_single(self, output, input, opts=None):
        """``output`` (``world`` times ``input``'s elements) <- every
        rank's ``input``, in rank order."""
        if output.numel() != self._world * input.numel():
            raise ValueError(f"{BACKEND}: all-gather of {tuple(input.shape)}"
                             f" into {tuple(output.shape)}")
        host_out = [torch.empty(input.shape, dtype=input.dtype)
                    for _ in range(self._world)]

        def fn(host):
            self._gloo.allgather([host_out], [host[0]]).wait()
        self._run([input], fn, write_back=())
        output.copy_(torch.cat([h.reshape(-1) for h in host_out])
                     .reshape(output.shape))
        return _done(output)

    _allgather_base = all_gather_single

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        # the form DTensor's all-gather reaches (torch's funcol)
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter_single(self, output, input, opts=None):
        """The reduction over ranks of ``input``, this rank's chunk of
        it."""
        full = input.detach().clone()
        self._run([full], self._allreduce_host(opts))
        output.copy_(full.chunk(self._world)[self._rank].reshape(
            output.shape))
        return _done(output)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        # the form DTensor's reduce-scatter reaches (torch's funcol)
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def reduce_scatter(self, output_tensors, input_tensors, opts=None):
        for out, ins in zip(output_tensors, input_tensors):
            self.reduce_scatter_single(out, torch.cat([t.reshape(-1)
                                                       for t in ins]), opts)
        return _done(output_tensors)

    def all_to_all_single(self, output, input, output_split_sizes=None,
                          input_split_sizes=None, opts=None):
        """Equal splits only: rank r's chunk s goes to rank s's chunk r."""
        for sizes in (output_split_sizes, input_split_sizes):
            if sizes and len(set(sizes)) > 1:
                raise NotImplementedError(f"{BACKEND}: all-to-all with "
                                          f"unequal splits {sizes}")
        gathered = torch.empty((self._world,) + tuple(input.shape),
                               dtype=input.dtype, device=input.device)
        self.all_gather_single(gathered, input.contiguous())
        mine = [g.chunk(self._world)[self._rank] for g in gathered]
        output.copy_(torch.cat(mine).reshape(output.shape))
        return _done(output)

    alltoall_base = all_to_all_single

    def getBackendName(self) -> str:
        return BACKEND

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    def __repr__(self) -> str:
        return f"HostStagedGloo(rank={self._rank}, size={self._world})"


def _create(store, rank: int, world_size: int, timeout: timedelta):
    return HostStagedGloo(store, rank, world_size, timeout)


if BACKEND not in dist.Backend.backend_list:
    dist.Backend.register_backend(BACKEND, _create, devices=["cpu", "cuda"])


def backend_for(device: torch.device, world_size: int) -> str:
    """NCCL for ranks on distinct cards, ``repro_gloo`` for ranks that
    share one, gloo on the CPU."""
    if device.type != "cuda":
        return "gloo"
    if world_size > torch.cuda.device_count():
        return BACKEND
    return "nccl"


def init_spmd(device: DeviceLike = "cuda", *, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout_s: float = 600.0) -> torch.device:
    """Start this rank's process group and return its device
    (``device.rank_device``). Without arguments it reads the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``; the store at
    ``MASTER_ADDR``:``MASTER_PORT``)."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    init_method = init_method or "env://"
    dev = rank_device(device, rank)
    dist.init_process_group(backend_for(dev, world_size), init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def spmd() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()
