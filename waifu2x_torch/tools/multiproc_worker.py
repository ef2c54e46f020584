"""One process of a multi-process run of the sharded kernel step and the
sharded train step (the counterpart of the JAX package's
tools/multiproc_worker.py).

Runs the multi-process branches of parallel/multihost.py that one process
never reaches: initialize (torch.distributed.init_process_group) and
shard_host_batch (each process places only its own frames). Each process
holds 4 positions (4 CPU positions under --device cpu, its one card under
--device cuda); the ("dp", "sp") mesh has "dp" across processes, and the
sharded 2x step (parallel/fast_sharded.py, the conv-stack kernels or their
plain versions on the CPU) must equal, block by block and bit for bit, the
single-process step that each process computes alone. Then the mesh is
rebuilt with "sp" across every process (1 x 4 * procs) and the step runs
again: the halo between the last position of one process and the first of
the next is a send/recv between processes (gloo on the CPU, NCCL on cards).
Last, a train step (train.make_sharded_train_step, TrainConfig(batch_size=
2 * procs, crop_size=32)) on the first mesh, each process feeding its own
"dp" slice and the gradients all-reduced between the processes: its loss
must be within 1e-5 of the single-process step on the whole batch, which
each process computes itself, and the params that it leaves must be the
same in every process, bit for bit.

    python -m waifu2x_torch.tools.multiproc_worker --coord localhost:PORT \\
        --procs 2 --rank R --device cpu

Every process of the group runs it, each with its own --rank.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

POSITIONS = 4   # mesh positions a process holds on the CPU


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True, help="host:port of rank 0")
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: card rank % count per process, NCCL; cpu: "
                         f"{POSITIONS} CPU positions per process, gloo")
    args = ap.parse_args(argv)

    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.parallel import mesh as w2x_mesh
    from waifu2x_torch.parallel import multihost
    from waifu2x_torch.parallel.fast_sharded import scale2x_u8_s2d_sharded
    from waifu2x_torch.pipeline import (FastStack, resolve_device,
                                        scale2x_batch_u8_s2d)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        w2x_mesh.CPU_DEVICES = POSITIONS
    multihost.initialize(args.coord, args.procs, args.rank)
    per_proc = len(w2x_mesh.local_devices(dev))
    tag = f"rank {args.rank}"

    mesh = multihost.global_mesh(device=dev)        # dp = procs
    assert mesh.shape == (args.procs, per_proc), mesh.shape

    # every process makes ALL frames (for its own reference) but places
    # only its own "dp" slice
    rng = np.random.default_rng(0)
    frames = rng.random((2 * args.procs, 24, 40, 3), dtype=np.float32)
    n_local = frames.shape[0] // args.procs
    local = frames[args.rank * n_local:(args.rank + 1) * n_local]
    gbatch = multihost.shard_host_batch(local, mesh)
    assert gbatch.shape == frames.shape, gbatch.shape

    fast = FastStack.build(init_params(5), scale_input=True,
                           dtype=torch.float32, device=dev)
    ref = scale2x_batch_u8_s2d(torch.from_numpy(frames).to(dev),
                               fast).cpu().numpy()

    def check(out, what):
        assert out.blocks, f"{tag}: no block in this process"
        for pos, block in out.blocks.items():
            got, want = block.cpu().numpy(), ref[out.index(pos)]
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(
                    f"{tag}: {what} block {pos} differs from the single-"
                    f"process step")

    check(scale2x_u8_s2d_sharded(gbatch, fast, mesh), "dp across processes")

    # "sp" across every process: a halo crosses between processes. Each
    # process places its own share of the width.
    mesh_x = multihost.global_mesh(dp=1, device=dev)
    assert mesh_x.shape == (1, per_proc * args.procs), mesh_x.shape
    wloc = frames.shape[2] // args.procs
    gx = w2x_mesh.shard_local(
        torch.from_numpy(np.ascontiguousarray(
            frames[:, :, args.rank * wloc:(args.rank + 1) * wloc])),
        mesh_x, ("dp", None, "sp", None))
    assert gx.shape == frames.shape, gx.shape
    check(scale2x_u8_s2d_sharded(gx, fast, mesh_x), "sp across processes")
    print(f"{tag}: cross-process halo exchange OK (sp="
          f"{per_proc * args.procs} spans {args.procs} processes, "
          f"bit-equal)", flush=True)
    train_check(args, dev, mesh, rng, n_local, tag)
    print(f"{tag}: OK ({args.procs} processes, "
          f"{per_proc * args.procs} positions)", flush=True)

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def train_check(args, dev, mesh, rng, n_local: int, tag: str) -> None:
    """The sharded train step across the processes ("dp" over them) against
    the single-process step on the whole batch."""
    import torch.distributed as dist

    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.train import train

    cfg = train.TrainConfig(batch_size=2 * args.procs, crop_size=32)
    opt = cfg.make_optimizer()
    crop, off = cfg.crop_size, 7
    xb = rng.random((cfg.batch_size, crop, crop, 1), dtype=np.float32)
    yb = rng.random((cfg.batch_size, crop - 2 * off, crop - 2 * off, 1),
                    dtype=np.float32)
    mine = slice(args.rank * n_local, (args.rank + 1) * n_local)
    p = train.trainable(init_params(5), dev)
    p, _, loss = train.make_sharded_train_step(mesh, opt)(
        p, opt.init(p), xb[mine], yb[mine])
    loss = float(loss)
    q = train.trainable(init_params(5), dev)
    _, _, ref = train.make_train_step(opt)(q, opt.init(q), xb, yb)
    ref = float(ref)
    if not abs(loss - ref) <= 1e-5 * max(1.0, abs(ref)):
        raise AssertionError(f"{tag}: sharded train loss {loss} != {ref}")
    if dist.is_initialized():
        flat = torch.cat([t.detach().reshape(-1) for t in train.leaves(p)])
        first = flat.clone()
        dist.broadcast(first, 0)
        if not torch.equal(flat, first):
            raise AssertionError(f"{tag}: the params differ from rank 0's "
                                 f"after the step")
    print(f"{tag}: train step loss {loss:.6f} (matches single-process "
          f"{ref:.6f}; params equal in every process)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
