"""One process driving a grid of devices: the port's counterpart of what the
JAX package takes from its library (jax.sharding.Mesh, shard_map and
lax.ppermute), which PyTorch has no single-process form of.

  Mesh       a numpy object array of torch.device shaped by named axes, and
             for several processes the rank that holds each position. A
             device may repeat: a mesh of 8 positions on one card (or on the
             CPU) runs its shards one after another there, as JAX's virtual
             host devices do.
  Sharded    a global tensor held as its blocks, one per mesh position, each
             on its position's device (only this process's positions).
  shard / shard_local / gather
             place a global tensor (or this process's part of one) on the
             mesh, and bring the blocks back into one tensor (edge_pad
             first grows a tensor to sizes the mesh divides; HostCopy
             brings the blocks to the host without waiting).
  shard_map  runs a local body at each position, under that position's
             device (torch.cuda.device), with that position's blocks.
  halo       the halo exchange that stands in for ppermute: a neighbour's
             edge slice copied to my device. On one device the copy is a
             view; between cards a peer copy, which PyTorch orders against
             both cards' current streams; between processes a
             torch.distributed send/recv (batch_isend_irecv: NCCL on cards,
             gloo on the CPU).
  replicate  one copy per distinct device of whatever a body reads (the
             kernel stacks' weights): JAX replicates them into shard_map
             unasked.

A block's slice of the global tensor follows a spec, one entry per tensor
dim: a mesh axis name (the dim is split over that axis) or None (whole).
Axes a spec does not name hold the same block at every index.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

CPU_DEVICES = 1
# The CPU positions a mesh may take on the host: the counterpart of the
# JAX package's virtual host device count (XLA's
# --xla_force_host_platform_device_count). The CLI raises it for an
# explicit mesh under --device cpu, and tests set it; nothing else does.


def local_devices(device="cuda") -> list:
    """The devices a mesh of this process may span: every CUDA card ("cuda"),
    the one card named ("cuda:i"), or CPU_DEVICES positions on the CPU (the
    one CPU device, repeated)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_DEVICES


def _norm(device) -> torch.device:
    """torch.device with the index a CUDA tensor reports (cuda -> cuda:i)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """devices: object array of torch.device, one axis per name. owners:
    int array of the same shape, the rank holding each position (None: this
    process holds every position); rank: this process's."""

    devices: np.ndarray
    axis_names: tuple
    owners: "np.ndarray | None" = None
    rank: int = 0

    def __post_init__(self):
        given = np.asarray(self.devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(devs.shape):
            devs[pos] = _norm(given[pos])
        self.devices = devs
        self.axis_names = tuple(self.axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devs.shape} with axes "
                             f"{self.axis_names}")
        if self.owners is not None:
            self.owners = np.asarray(self.owners, dtype=np.int64)
            if self.owners.shape != devs.shape:
                raise ValueError(f"owners {self.owners.shape} != mesh "
                                 f"{devs.shape}")

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def positions(self) -> list:
        """Every position, in the one order that every process uses."""
        return list(np.ndindex(self.shape))

    def is_local(self, pos) -> bool:
        return self.owners is None or int(self.owners[pos]) == self.rank

    def local_positions(self) -> list:
        return [p for p in self.positions() if self.is_local(p)]

    def device(self, pos) -> torch.device:
        return self.devices[pos]

    def owner(self, pos) -> int:
        return self.rank if self.owners is None else int(self.owners[pos])


def make_mesh(shape, axis_names, devices) -> Mesh:
    """A mesh of `shape` over `devices` in order; their number must equal
    the mesh's size, as in the JAX package."""
    devices = list(devices)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh {tuple(shape)} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


class Sharded:
    """A global tensor of `shape` split over `mesh` by `spec`; `blocks` maps
    each of this process's positions to its block, on that position's
    device."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple, blocks: dict):
        if len(spec) != len(shape):
            raise ValueError(f"spec {spec} for a tensor of {len(shape)} dims")
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.blocks = tuple(int(s) for s in shape), blocks

    @property
    def block_shape(self) -> tuple:
        return tuple(s // (1 if a is None else self.mesh.axis_size(a))
                     for s, a in zip(self.shape, self.spec))

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def index(self, pos) -> tuple:
        """The global tensor's slice that the block at `pos` holds."""
        out = []
        for b, a in zip(self.block_shape, self.spec):
            i = 0 if a is None else pos[self.mesh.axis_names.index(a)]
            out.append(slice(i * b, (i + 1) * b))
        return tuple(out)


def edge_pad(x: torch.Tensor, sizes) -> torch.Tensor:
    """x grown to `sizes` (one per leading dim; the rest keep theirs) by
    repeating the last slice of each grown dim."""
    for d, s in enumerate(sizes):
        n = x.shape[d]
        if s > n:
            rep = list(x.shape)
            rep[d] = s - n
            x = torch.cat([x, x.narrow(d, n - 1, 1).expand(rep)], dim=d)
    return x


def _check_divides(shape, mesh: Mesh, spec) -> None:
    for d, (s, a) in enumerate(zip(shape, spec)):
        if a is not None and s % mesh.axis_size(a):
            raise ValueError(f"dim {d} ({s}) does not divide the {a!r} axis "
                             f"({mesh.axis_size(a)}); pad first")


def shard(x: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """Place the global tensor x on the mesh: each of this process's
    positions gets its block, copied to its device."""
    _check_divides(x.shape, mesh, spec)
    out = Sharded(mesh, spec, x.shape, {})
    for pos in mesh.local_positions():
        out.blocks[pos] = x[out.index(pos)].to(mesh.device(pos),
                                               non_blocking=True)
    return out


def shard_local(local: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """Place this process's part of a global tensor: `local` covers the box
    of blocks that this process's positions hold (along each split dim, the
    contiguous range of indices its positions take), as JAX's
    make_array_from_process_local_data takes it."""
    names = mesh.axis_names
    mine = mesh.local_positions()
    lo = {a: min(p[names.index(a)] for p in mine) for a in names}
    hi = {a: max(p[names.index(a)] for p in mine) for a in names}
    shape = []
    for s, a in zip(local.shape, spec):
        if a is None:
            shape.append(s)
            continue
        span = hi[a] - lo[a] + 1
        if s % span:
            raise ValueError(f"local dim {s} does not divide the {span} "
                             f"{a!r} positions this process holds")
        shape.append(s // span * mesh.axis_size(a))
    out = Sharded(mesh, spec, shape, {})
    for pos in mine:
        idx = []
        for sl, a in zip(out.index(pos), spec):
            off = 0 if a is None else lo[a] * (sl.stop - sl.start)
            idx.append(slice(sl.start - off, sl.stop - off))
        out.blocks[pos] = local[tuple(idx)].to(mesh.device(pos),
                                               non_blocking=True)
    return out


def _selected(x: Sharded, fixed: dict) -> list:
    """The positions whose blocks make up the global tensor (index 0 on the
    axes the spec does not name), restricted to `fixed` {axis: index}."""
    names = x.mesh.axis_names
    return [p for p in x.mesh.positions()
            if all(p[i] == fixed.get(a, 0) for i, a in enumerate(names)
                   if a not in x.spec or a in fixed)]


def gather(x: Sharded, device=None, **fixed) -> torch.Tensor:
    """The global tensor on `device` (default: the mesh's first device).
    With axis=index keywords, only the blocks at that index of that axis:
    the dims split over it keep one block's size. Every block it needs must
    be this process's."""
    pos = _selected(x, fixed)
    if not all(x.mesh.is_local(p) for p in pos):
        raise ValueError("gather needs every block in this process; the "
                         "mesh spans processes")
    dev = _norm(device) if device is not None else x.mesh.devices.flat[0]
    shape = [b if a in fixed else s
             for s, b, a in zip(x.shape, x.block_shape, x.spec)]
    out = torch.empty(shape, dtype=x.dtype, device=dev)
    for p in pos:
        idx = tuple(slice(0, b) if a in fixed else sl for sl, b, a in
                    zip(x.index(p), x.block_shape, x.spec))
        out[idx] = x.blocks[p]
    return out


def shard_map(body, *args: Sharded, spec=None) -> Sharded:
    """body(*blocks) -> block, run at each of this process's positions under
    its device; the blocks it returns make a Sharded of `spec` (default: the
    first argument's). Every position's result must have one shape."""
    mesh = args[0].mesh
    spec = args[0].spec if spec is None else tuple(spec)
    blocks = {}
    for pos in mesh.local_positions():
        dev = mesh.device(pos)
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            blocks[pos] = body(*(a.blocks[pos] for a in args))
    first = next(iter(blocks.values()))
    shape = [s * (1 if a is None else mesh.axis_size(a))
             for s, a in zip(first.shape, spec)]
    return Sharded(mesh, spec, shape, blocks)


def move(x: Sharded, moves: list) -> dict:
    """Carry slices between positions. moves: (src, dst, fn) triples in an
    order every process shares; fn(block) is the slice of src's block that
    dst needs. Returns {(src, dst): slice on dst's device} for this
    process's dst. A copy between two of this process's devices is a view
    (one device) or a peer copy; between processes a send/recv, all of
    them posted in one batch_isend_irecv and waited for."""
    mesh = x.mesh
    got, ops, sent = {}, [], []
    meta = torch.empty(x.block_shape, dtype=x.dtype, device="meta")
    for tag, (src, dst, fn) in enumerate(moves):
        s_here, d_here = mesh.is_local(src), mesh.is_local(dst)
        if s_here and d_here:
            got[(src, dst)] = fn(x.blocks[src]).to(mesh.device(dst))
        elif d_here:
            import torch.distributed as dist
            buf = torch.empty(fn(meta).shape, dtype=x.dtype,
                              device=mesh.device(dst))
            got[(src, dst)] = buf
            ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(src), tag=tag))
        elif s_here:
            import torch.distributed as dist
            t = fn(x.blocks[src]).contiguous()
            sent.append(t)   # held until the send completes
            ops.append(dist.P2POp(dist.isend, t, mesh.owner(dst), tag=tag))
    if ops:
        import torch.distributed as dist
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


def _at(pos, axis: int, i: int) -> tuple:
    return pos[:axis] + (i,) + pos[axis + 1:]


def halo(x: Sharded, k: int, axis_name: str, dim: int) -> Sharded:
    """Attach k slices of halo on both sides of tensor dim `dim` from the
    neighbours along `axis_name`; at the true borders replicate the block's
    own edge (BORDER_REPLICATE, convertRoutine.cpp:35-36)."""
    mesh = x.mesh
    a = mesh.axis_names.index(axis_name)
    n, size = mesh.axis_size(axis_name), x.block_shape[dim]
    if n > 1 and size < k:
        raise ValueError(
            f"shard ({size} px on axis {dim}) narrower than the {k}-px "
            f"halo — use fewer {axis_name!r} devices for this image")
    moves = []
    for pos in mesh.positions():
        i = pos[a]
        if i > 0:       # my low side: the previous block's last k slices
            moves.append((_at(pos, a, i - 1), pos,
                          lambda b: b.narrow(dim, size - k, k)))
        if i < n - 1:   # my high side: the next block's first k slices
            moves.append((_at(pos, a, i + 1), pos,
                          lambda b: b.narrow(dim, 0, k)))
    got = move(x, moves)
    blocks = {}
    for pos, b in x.blocks.items():
        i = pos[a]
        rep = list(b.shape)
        rep[dim] = k
        lo = (got[(_at(pos, a, i - 1), pos)] if i > 0
              else b.narrow(dim, 0, 1).expand(rep))
        hi = (got[(_at(pos, a, i + 1), pos)] if i < n - 1
              else b.narrow(dim, size - 1, 1).expand(rep))
        blocks[pos] = torch.cat([lo, b, hi], dim=dim)
    shape = list(x.shape)
    shape[dim] = (size + 2 * k) * (1 if x.spec[dim] is None
                                   else mesh.axis_size(x.spec[dim]))
    return Sharded(mesh, x.spec, shape, blocks)


def to_device(obj, device):
    """obj with every tensor in it on `device`: tensors, tuples, lists and
    dicts of them, dataclasses (pipeline.FastStack) and tuples that carry
    attributes (ops.stack.StackParams: every attribute, whatever its
    name)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        out = type(obj)(to_device(v, device) for v in obj)
        for name, v in getattr(obj, "__dict__", {}).items():
            setattr(out, name, to_device(v, device))
        return out
    return obj


def replicate(obj, mesh: Mesh) -> dict:
    """{device: obj on that device} for each distinct device of this
    process's positions (a tensor already there is not copied)."""
    devs = dict.fromkeys(mesh.device(p) for p in mesh.local_positions())
    return {d: to_device(obj, d) for d in devs}


class HostCopy:
    """The blocks of a Sharded on their way to the host: each block copied,
    without waiting, into a buffer of its own (pinned where the block is on
    a card), and one CUDA event recorded on each card after its copies.
    The buffers live as long as this object: keep it until wait()."""

    def __init__(self, x: Sharded):
        self.x = x
        self.bufs, self.events = {}, []
        cards = {}
        for p in _selected(x, {}):
            b = x.blocks[p]
            on_card = b.device.type == "cuda"
            buf = torch.empty(b.shape, dtype=b.dtype, pin_memory=on_card)
            if on_card:
                with torch.cuda.device(b.device):
                    buf.copy_(b, non_blocking=True)
                cards[b.device] = True
            else:
                buf.copy_(b)
            self.bufs[p] = buf
        for dev in cards:
            with torch.cuda.device(dev):
                ev = torch.cuda.Event()
                ev.record()
                self.events.append(ev)

    def wait(self) -> np.ndarray:
        """Wait for the copies; the global array as numpy."""
        for ev in self.events:
            ev.synchronize()
        if len(self.bufs) == 1:
            return next(iter(self.bufs.values())).numpy()
        first = next(iter(self.bufs.values()))
        out = np.empty(self.x.shape, dtype=first.numpy().dtype)
        for p, buf in self.bufs.items():
            out[self.x.index(p)] = buf.numpy()
        return out
