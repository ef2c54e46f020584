"""Several processes (the counterpart of the JAX package's
parallel/multihost.py). The reference has no distributed runtime (one
process, std::thread only, modelHandler.cpp:42-69). Here every process runs
the same program: initialize wires the group (torch.distributed: NCCL on
cards, gloo on the CPU), global_mesh lays one mesh over every process's
devices with the rank that holds each position, and the sharded paths run
unchanged: a halo between two positions of one process is a copy, one that
crosses processes a send/recv (parallel/mesh.py: move).

This module holds the host-side plumbing: the group's set-up, the global
mesh, each process's frames placed on its own positions, and the
throughput / scaling-efficiency report.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from waifu2x_torch.parallel import mesh as m


def initialize(coordinator_address: "str | None" = None,
               num_processes: "int | None" = None,
               process_id: "int | None" = None,
               backend: "str | None" = None) -> None:
    """Join the process group at coordinator_address ("host:port"), as
    process process_id of num_processes. A no-op for one process (one host
    and every test but the 2-process one). backend: "nccl" where a card is
    present, else "gloo"; with NCCL, each process selects its card
    (torch.cuda.set_device) before its first send."""
    if num_processes is not None and num_processes > 1:
        import torch.distributed as dist
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def _group() -> "tuple[int, int]":
    """(world size, rank): (1, 0) outside a process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(dp: "int | None" = None, sp: "int | None" = None,
                device="cuda") -> m.Mesh:
    """A ("dp", "sp") mesh over every process's devices
    (mesh.local_devices(device) in each, the same number in each, in rank
    order). Default: "dp" across processes (frames data-parallel: no halo
    crosses a process) and "sp" over each process's own devices; dp or sp
    set the other layouts."""
    world, rank = _group()
    local = m.local_devices(device)
    n = len(local) * world
    if dp is None and sp is None:
        dp = world
        sp = n // dp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh ({dp},{sp}) != {n} devices")
    devices = np.empty(n, dtype=object)
    devices[:] = local * world     # another process's devices: placeholders
    owners = np.repeat(np.arange(world), len(local))
    return m.Mesh(devices.reshape(dp, sp), ("dp", "sp"),
                  owners.reshape(dp, sp) if world > 1 else None, rank)


def shard_host_batch(local_batch, mesh: m.Mesh) -> m.Sharded:
    """The global batch from each process's frames: each process passes its
    own [n_local, h, w, c] and gets the global [n_local * processes, h, w,
    c] batch sharded ("dp", None, "sp", None), each process's frames on its
    own positions, with no data crossing processes."""
    if isinstance(local_batch, np.ndarray):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    return m.shard_local(local_batch, mesh, ("dp", None, "sp", None))


@dataclasses.dataclass
class ScalingReport:
    """MP/s and the scaling efficiency against one device (the >= 80%
    north-star of BASELINE.md)."""

    devices: int
    mp_per_s: float
    baseline_mp_per_s: "float | None" = None

    @property
    def efficiency(self) -> "float | None":
        if not self.baseline_mp_per_s:
            return None
        return self.mp_per_s / (self.baseline_mp_per_s * self.devices)

    def line(self) -> str:
        eff = self.efficiency
        eff_s = f", efficiency {eff * 100:.1f}%" if eff is not None else ""
        return f"{self.devices} device(s): {self.mp_per_s:.1f} MP/s{eff_s}"


def synchronize() -> None:
    """Wait for every card's work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def measure_throughput(step_fn, batch, out_pixels: int, iters: int = 10,
                       baseline_mp_per_s: "float | None" = None,
                       devices: int = 1) -> ScalingReport:
    """Steady-state MP/s of step_fn(batch) over `devices` devices: one
    warm-up call, then `iters` calls between two synchronisations of every
    card, on the host's clock."""
    step_fn(batch)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(batch)
    synchronize()
    dt = time.perf_counter() - t0
    return ScalingReport(devices, out_pixels * iters / dt / 1e6,
                         baseline_mp_per_s)
