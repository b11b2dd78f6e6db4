"""Device meshes of the port (counterpart of ``jax.make_mesh`` /
``jax.sharding.Mesh`` as the reference uses them).

A :class:`Mesh` names its axes and their sizes, and gives every shard a
device.  It comes in two kinds that share every line of round arithmetic
(``core/mixing.py``) and differ only in which node shards a process owns
and how rows and sums travel between shards:

* the **local** mesh (``make_mesh`` without ``group``): all k node shards
  in this process on one device, as the reference's suites run theirs on
  one physical CPU split into forced host devices.  A ``ppermute`` is a
  row-block slice and a ``psum`` a left fold over the shards in order;
* the **rank** mesh (``make_mesh(..., group=g)``): one
  ``torch.distributed`` rank per node shard, this process shard
  ``g.rank()`` holding only its m = n/k rows.  Rows and sums travel
  through the mesh's :class:`Exchange`.

:class:`Exchange` has four primitives, each with the local mesh's
counterpart in ``core/mixing.py``: the halo (:meth:`Exchange.halo`: send
the own row-block to shard ``(r − q) mod k`` and receive shard ``(r + q)
mod k``'s, every offset's sends and receives posted together), the
fixed-order sum over shards (:meth:`Exchange.fold`: an ``all_gather`` of
each rank's partial, then the left fold r = 0 … k − 1 — not
``all_reduce``, whose order is the backend's), ``all_to_all`` of column
segments and ``all_gather``.  Payloads travel as bytes, so every dtype
moves bit for bit.  The transport follows the group's backend: ``nccl``
takes CUDA tensors as they are; ``gloo`` takes CPU tensors as they are
and CUDA tensors through pinned host buffers (copy out, exchange, copy
in), allocated once per rank, grown to the largest round and reused.
Any other combination raises.

:func:`run_ranks` starts the k rank processes on one machine (the
``spawn`` start method, a ``file://`` store in a fresh temporary
directory), joins them under a time limit and raises with the failing
rank's traceback: the one-machine counterpart of the reference's forced
host devices, used by the rank tests and ``chip_smoke.py``.

2-D ``(node, model)`` meshes (ROADMAP A.10.2): a mesh may carry a model
axis (``DistConfig.model_axis``, ``"model"`` by default) beside its node
axes, ``(data, model)`` or ``(pod, data, model)``.  The sharded rounds
then also slice the packed columns over it (``core/mixing.py``): block
(node shard r, model shard c) is the m rows of shard r in column chunk c.
On a local mesh every block lives in this process.  A rank mesh has one
rank per block, row-major over the axes; a rank holds the m rows of its
node shard whole (the forward needs whole params) and owns column chunk
c in a round.  Its ``exchange`` is then the node-axis sub-exchange (the
k ranks with the same c: halo, fixed-order sum, ``all_to_all``,
``all_gather``) and ``model_exchange`` the model-axis one (the k_model
ranks with the same r), whose ``all_gather`` puts a round's chunks back
into whole rows.  Every rank creates the sub-groups in the same order.

Not ported (``NotImplementedError``, ROADMAP A.10): a local mesh over
several cards.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import not_ported

_ALIGN = 16          # byte alignment of each array in a packed message


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes over shards that sit on ``device``.  ``group`` (a
    ``torch.distributed`` process group of one rank per shard) makes it a
    rank mesh: this process is shard ``rank`` (row-major over the axes),
    node shard ``node_rank`` of ``node_count`` and model shard
    ``model_rank`` of ``k_model``; it moves rows through ``exchange``
    (over the node axes) and ``model_exchange`` (over ``model_axis``,
    None when that axis has one shard)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    group: Any = None
    rank: int = 0
    exchange: Optional["Exchange"] = dataclasses.field(default=None,
                                                       compare=False)
    model_axis: Optional[str] = None
    node_rank: int = 0
    model_rank: int = 0
    model_exchange: Optional["Exchange"] = dataclasses.field(
        default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """One device per shard, row-major over the axes (a rank mesh
        knows only its own)."""
        return (self.device,) * self.size

    @property
    def distributed(self) -> bool:
        """True for a rank mesh (one process per block)."""
        return self.group is not None

    @property
    def k_model(self) -> int:
        """A rank mesh's model shards (1 without a model axis)."""
        return self.shape.get(self.model_axis, 1) if self.model_axis else 1

    @property
    def node_count(self) -> int:
        """A rank mesh's node shards: its ranks over ``k_model``."""
        return self.size // self.k_model

    def owned_shards(self, k: int) -> Tuple[int, ...]:
        """Of a round's k node shards, the ones this process holds rows
        of, in row order: all k, or this rank's."""
        return (self.node_rank,) if self.distributed else tuple(range(k))


def _physical(device) -> Tuple[str, int]:
    """``(type, index)`` of a device, an unindexed card read as card 0."""
    dev = torch.device(device)
    return dev.type, 0 if dev.index is None else dev.index


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device="cuda", devices: Optional[Sequence] = None,
              group=None) -> Mesh:
    """A mesh of ``prod(axis_shapes)`` shards.

    Without ``group``: every shard on one device in this process.
    ``device`` is resolved as every entry point of the port resolves it
    (the card unless ``"cpu"`` is passed); ``devices`` optionally names a
    device per shard, all the same device.

    With ``group``, a ``torch.distributed`` process group of one rank per
    shard: this process is shard ``group.rank()``, on ``devices[rank]``
    when ``devices`` is given, else on ``device``.  Its node axes are
    ``pod`` and ``data``; one more axis, of more than one shard, is the
    model axis, and the group is then split into node-axis and model-axis
    sub-groups (collectively: every rank of ``group`` must call this).
    """
    shapes = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"make_mesh: {len(shapes)} axis sizes for "
                         f"{len(names)} axis names")
    if len(set(names)) != len(names):
        raise ValueError(f"make_mesh: repeated axis name in {names}")
    if any(s < 1 for s in shapes):
        raise ValueError(f"make_mesh: axis sizes must be >= 1, got {shapes}")
    size = int(np.prod(shapes, dtype=np.int64))
    if devices is not None and len(devices) != size:
        raise ValueError(f"make_mesh: {len(devices)} devices for a mesh "
                         f"of {shapes}")
    if group is None:
        if devices is not None:
            if len({_physical(d) for d in devices}) > 1:
                raise not_ported("a one-process mesh over several cards "
                                 "(give make_mesh a process group "
                                 "instead)", "A.10")
            device = devices[0]
        return Mesh(axis_names=names, axis_sizes=shapes,
                    device=_resolve(device))
    import torch.distributed as dist
    if dist.get_world_size(group) != size:
        raise ValueError(f"make_mesh: a group of {dist.get_world_size(group)}"
                         f" ranks for a mesh of {size} shards")
    rank = dist.get_rank(group)
    dev = _resolve(devices[rank] if devices is not None else device)
    others = [a for a, k in zip(names, shapes)
              if a not in ("pod", "data") and k > 1]
    if len(others) > 1:
        raise ValueError(f"make_mesh: a rank mesh has node axes (pod, "
                         f"data) and at most one model axis, got "
                         f"{dict(zip(names, shapes))}")
    if not others or len(names) == 1:     # one node shard a rank
        return Mesh(axis_names=names, axis_sizes=shapes, device=dev,
                    group=group, rank=rank, exchange=Exchange(group, dev),
                    node_rank=rank)
    model_axis = others[0]
    node_group, model_group, node_rank, model_rank = _sub_groups(
        group, shapes, names, model_axis)
    return Mesh(axis_names=names, axis_sizes=shapes, device=dev, group=group,
                rank=rank, exchange=Exchange(node_group, dev),
                model_axis=model_axis, node_rank=node_rank,
                model_rank=model_rank,
                model_exchange=Exchange(model_group, dev))


def _resolve(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sub_groups(group, shapes, names, model_axis: str):
    """The node-axis and model-axis sub-groups of a 2-D rank mesh and this
    rank's ``(node_group, model_group, node_rank, model_rank)``.  Block
    coordinates are row-major over the axes; the node index is row-major
    over the node axes in ``(pod, data)`` order, which must be the order
    of the ranks (a group lists its ranks in ascending order).  Every rank
    creates every sub-group, model chunks first, in the same order."""
    import torch.distributed as dist
    size = int(np.prod(shapes, dtype=np.int64))
    mi = names.index(model_axis)
    node_axes = [i for i in range(len(names)) if i != mi]
    order = sorted(node_axes, key=lambda i: ("pod", "data").index(names[i])
                   if names[i] in ("pod", "data") else 2)
    gl = [dist.get_global_rank(group, g) for g in range(size)]
    coords = [np.unravel_index(g, shapes) for g in range(size)]

    def node_index(cd):
        idx = 0
        for i in order:
            idx = idx * shapes[i] + int(cd[i])
        return idx

    k_model = shapes[mi]
    k = size // k_model
    by_chunk = [[g for g in range(size) if int(coords[g][mi]) == c]
                for c in range(k_model)]
    by_node = [[g for g in range(size) if node_index(coords[g]) == r]
               for r in range(k)]
    for ranks in by_chunk:
        if [node_index(coords[g]) for g in ranks] != list(range(k)):
            raise ValueError(f"make_mesh: the rank mesh "
                             f"{dict(zip(names, shapes))} must list its node "
                             f"axes in (pod, data) order")
    me = dist.get_rank(group)
    node_group = model_group = None
    for ranks in by_chunk:
        g = dist.new_group([gl[i] for i in ranks])
        if me in ranks:
            node_group = g
    for ranks in by_node:
        g = dist.new_group([gl[i] for i in ranks])
        if me in ranks:
            model_group = g
    return (node_group, model_group, node_index(coords[me]),
            int(coords[me][mi]))


# ---------------------------------------------------------------------------
# The exchange of a rank mesh
# ---------------------------------------------------------------------------
def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def pack_arrays(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Arrays of any dtypes and shapes as one flat uint8 message, each at
    a 16-byte-aligned offset (:func:`unpack_arrays` inverts it)."""
    parts = []
    for a in arrays:
        b = _as_bytes(a)
        parts.append(b)
        pad = -b.numel() % _ALIGN
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8,
                                     device=b.device))
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)


def unpack_arrays(msg: torch.Tensor, like: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Views into ``msg`` shaped and typed as ``like``'s arrays."""
    out, off = [], 0
    for a in like:
        nb = a.numel() * a.element_size()
        out.append(msg[off:off + nb].view(a.dtype).reshape(a.shape))
        off += nb + (-nb % _ALIGN)
    return out


class Exchange:
    """The primitives of a rank mesh over ``group`` for tensors on
    ``device`` (see the module docstring for the transports).

    ``stats`` counts, since the last :meth:`reset_stats`: ``bytes_out`` /
    ``bytes_in`` (payload bytes sent and received), ``ops`` (primitive
    calls), ``syncs`` (host waits for the stream before a staged
    exchange) and, while ``timing`` is set, the seconds spent in
    ``stage_out`` (device to pinned host, waited for), ``exchange`` (the
    backend's transfer) and ``stage_in`` (pinned host to device, waited
    for: ``timing`` adds that wait)."""

    def __init__(self, group, device: torch.device):
        import torch.distributed as dist
        self.group = group
        self.k = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # point-to-point ops name their peers by global rank
        self._peers = [dist.get_global_rank(group, g) for g in range(self.k)]
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group)).lower()
        kind = (self.backend, self.device.type)
        if kind not in (("gloo", "cpu"), ("gloo", "cuda"), ("nccl", "cuda")):
            raise ValueError(f"Exchange: no transport for backend "
                             f"{self.backend!r} with {self.device.type} "
                             f"tensors (gloo takes CPU or staged CUDA "
                             f"tensors, nccl CUDA tensors)")
        self.staged = kind == ("gloo", "cuda")
        self._pinned: Dict[str, torch.Tensor] = {}
        self.timing = False
        self.stats: Dict[str, float] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"bytes_out": 0, "bytes_in": 0, "ops": 0, "syncs": 0,
                      "stage_out": 0.0, "exchange": 0.0, "stage_in": 0.0}

    @property
    def pinned_bytes(self) -> int:
        """Host bytes held in this rank's pinned staging buffers."""
        return sum(b.numel() for b in self._pinned.values())

    # -- staging -----------------------------------------------------------
    def _buffer(self, name: str, nbytes: int) -> torch.Tensor:
        """The pinned uint8 buffer ``name``, grown to ``nbytes``."""
        buf = self._pinned.get(name)
        if buf is None or buf.numel() < nbytes:
            self._pinned.pop(name, None)
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[name] = buf
        return buf[:nbytes]

    def _out(self, msgs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The flat uint8 messages as the backend sends them: staged into
        the pinned ``out`` buffer (one stream wait) or as they are."""
        if not self.staged:
            return [m.contiguous() for m in msgs]
        t0 = time.perf_counter()
        buf = self._buffer("out", sum(m.numel() for m in msgs))
        host, off = [], 0
        for m in msgs:
            h = buf[off:off + m.numel()]
            h.copy_(m, non_blocking=True)
            host.append(h)
            off += m.numel()
        # the backend reads host memory: wait for the copies (and for any
        # earlier copy still reading the pinned buffers)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats["syncs"] += 1
        self.stats["stage_out"] += time.perf_counter() - t0
        return host

    def _in(self, sizes: Sequence[int]) -> List[torch.Tensor]:
        """Receive buffers of ``sizes`` bytes: pinned host memory when
        staged, else fresh tensors on the device."""
        if not self.staged:
            return [torch.empty(s, dtype=torch.uint8, device=self.device)
                    for s in sizes]
        buf = self._buffer("in", sum(sizes))
        out, off = [], 0
        for s in sizes:
            out.append(buf[off:off + s])
            off += s
        return out

    def _land(self, host: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy a received message into ``dst`` (its bytes)."""
        t0 = time.perf_counter()
        dst.view(-1).view(torch.uint8).copy_(host, non_blocking=True)
        if self.timing and self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        self.stats["stage_in"] += time.perf_counter() - t0

    def _account(self, out_bytes: int, in_bytes: int) -> None:
        self.stats["bytes_out"] += out_bytes
        self.stats["bytes_in"] += in_bytes
        self.stats["ops"] += 1

    def _sync_for_timing(self) -> None:
        if self.timing and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- primitives --------------------------------------------------------
    def sendrecv(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Point-to-point: each ``(peer, tensor)`` of ``sends`` goes to
        ``peer`` (a rank of this exchange's group), each of ``recvs`` is
        filled (in place, its bytes) from ``peer``.  Every send and
        receive is posted together (``batch_isend_irecv``) and waited for;
        at most one message a direction between two ranks."""
        import torch.distributed as dist
        if not sends and not recvs:
            return
        self._sync_for_timing()
        out = self._out([_as_bytes(t) for _, t in sends])
        dsts = [t for _, t in recvs]
        # unstaged, a receive lands in its destination's bytes directly
        inb = (self._in([t.numel() * t.element_size() for t in dsts])
               if self.staged else [t.view(-1).view(torch.uint8)
                                    for t in dsts])
        t0 = time.perf_counter()
        ops = ([dist.P2POp(dist.isend, m, self._peers[p], self.group)
                for (p, _), m in zip(sends, out)]
               + [dist.P2POp(dist.irecv, m, self._peers[p], self.group)
                  for (p, _), m in zip(recvs, inb)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats["exchange"] += time.perf_counter() - t0
        if self.staged:
            for h, d in zip(inb, dsts):
                self._land(h, d)
        self._account(sum(m.numel() for m in out),
                      sum(m.numel() for m in inb))

    def halo(self, block: torch.Tensor, offsets: Sequence[int]
             ) -> torch.Tensor:
        """The ``(|offsets|·m, D)`` stack of shard ``(r + q) mod k``'s
        row-block for each offset q, in offset order: this rank's own
        ``(m, D)`` ``block`` at q = 0, the others received while this
        rank's block goes to shard ``(r − q) mod k``.  The stack has
        ``block``'s dtype."""
        m = block.shape[0]
        stack = torch.empty((len(offsets) * m,) + tuple(block.shape[1:]),
                            dtype=block.dtype, device=block.device)
        sends, recvs = [], []
        for j, q in enumerate(offsets):
            dst = stack[j * m:(j + 1) * m]
            if q % self.k == 0:
                dst.copy_(block)
                continue
            sends.append(((self.rank - q) % self.k, block))
            recvs.append(((self.rank + q) % self.k, dst))
        self.sendrecv(sends, recvs)
        return stack

    def all_gather(self, part: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``part`` (one shape and dtype on all ranks), in
        rank order."""
        import torch.distributed as dist
        self._sync_for_timing()
        (msg,) = self._out([_as_bytes(part)])
        nb = msg.numel()
        (inb,) = self._in([nb * self.k])
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(inb, msg, group=self.group) \
            if self.backend == "nccl" else dist.all_gather(
                list(inb.chunk(self.k)), msg, group=self.group)
        self.stats["exchange"] += time.perf_counter() - t0
        got = torch.empty((self.k,) + tuple(part.shape), dtype=part.dtype,
                          device=part.device)
        self._land(inb, got)
        self._account(nb, nb * self.k)
        return list(got.unbind(0))

    def fold(self, part: torch.Tensor) -> torch.Tensor:
        """The fixed-order sum over shards: ``all_gather`` of each rank's
        ``part``, then the left fold r = 0 … k − 1 (the local mesh's
        ``acc = acc + part_r``), so every rank gets the same bits."""
        acc = None
        for p in self.all_gather(part):
            acc = p if acc is None else acc + p
        return acc

    def all_to_all(self, chunks: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``chunks[s]`` goes to rank s; returns the chunk each rank sent
        here, in rank order (all chunks of one shape and dtype)."""
        import torch.distributed as dist
        if len(chunks) != self.k:
            raise ValueError(f"all_to_all: {len(chunks)} chunks for "
                             f"{self.k} ranks")
        self._sync_for_timing()
        (msg,) = self._out([torch.cat([_as_bytes(c) for c in chunks])])
        (inb,) = self._in([msg.numel()])
        t0 = time.perf_counter()
        dist.all_to_all_single(inb, msg, group=self.group)
        self.stats["exchange"] += time.perf_counter() - t0
        c0 = chunks[0]
        got = torch.empty((self.k,) + tuple(c0.shape), dtype=c0.dtype,
                          device=c0.device)
        self._land(inb, got)
        self._account(msg.numel(), msg.numel())
        return list(got.unbind(0))


# ---------------------------------------------------------------------------
# Rank processes on one machine
# ---------------------------------------------------------------------------
def _rank_main(fn, rank: int, k: int, backend: str, device: str,
               store_dir: str, args: tuple, timeout_s: float, threads: int,
               queue) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, save its result
    to ``store_dir``, report ``(rank, ok, traceback)``."""
    import datetime

    import torch.distributed as dist
    try:
        torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{store_dir}/store", rank=rank,
            world_size=k, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
            torch.save(out, os.path.join(store_dir, f"result_{rank}.pt"))
            report = (rank, True, "")
        except BaseException:
            report = (rank, False, traceback.format_exc())
        # report before the group closes: a peer that fails because this
        # rank left reports after the cause
        queue.put(report)
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, k: int, *, backend: str = "gloo",
              device: str = "cpu", args: tuple = (),
              timeout_s: float = 120.0, threads: int = 1) -> List[Any]:
    """Run ``fn(rank, *args)`` in k fresh processes joined in one default
    process group (``backend``; ``device`` each rank's default device) and
    return their results in rank order (each saved with ``torch.save``:
    keep them on the host).  ``fn`` must be importable by module and name
    (the ``spawn`` start method).  Every rank runs with ``threads`` torch
    threads.  When a rank raises, dies or the ranks outlast ``timeout_s``,
    the others are killed and this raises ``RuntimeError`` with the
    failing rank's traceback (``TimeoutError`` for the limit)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="repro_ranks_")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, k, backend, device, store_dir, args,
                               timeout_s, threads, queue))
             for r in range(k)]
    deadline = time.monotonic() + timeout_s
    done: Dict[int, bool] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(done) < k and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = TimeoutError(
                    f"run_ranks: ranks {sorted(set(range(k)) - set(done))}"
                    f" of {k} still running after {timeout_s:.0f} s")
                break
            try:
                rank, ok, tb = queue.get(timeout=min(0.2, left))
            except Exception:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # give a late report from the dead rank a moment
                    time.sleep(0.5)
                    while not queue.empty():
                        rank, ok, tb = queue.get()
                        done[rank] = ok
                        if not ok:
                            failure = RuntimeError(
                                f"run_ranks: rank {rank} of {k} failed:\n"
                                f"{tb}")
                    dead = [r for r in dead if r not in done]
                    if dead and failure is None:
                        failure = RuntimeError(
                            f"run_ranks: rank {dead[0]} of {k} exited "
                            f"with code {procs[dead[0]].exitcode} without "
                            f"a result")
                continue
            done[rank] = ok
            if not ok:
                failure = RuntimeError(f"run_ranks: rank {rank} of {k} "
                                       f"failed:\n{tb}")
        if failure is not None:
            raise failure
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [torch.load(os.path.join(store_dir, f"result_{r}.pt"),
                           weights_only=False) for r in range(k)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        queue.close()
        shutil.rmtree(store_dir, ignore_errors=True)
