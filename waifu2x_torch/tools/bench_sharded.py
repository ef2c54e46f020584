"""The sharded 2x stream step on a ("dp", "sp") mesh (the counterpart of the
JAX package's tools/bench_sharded.py): parallel/fast_sharded.py's
convert_batch_on_mesh with the bf16 conv-stack kernels on every shard.

Prints ONE JSON line: MP/s of the step over the mesh, the mesh, the MP/s of
one device on one device's share (batch / dp frames, width / sp), and the
scaling efficiency between the two (the >= 80% north-star of BASELINE.md).
A mesh with more positions than the host has cards lays the positions over
the cards in turn ("virtual": several shards a card, run one after
another); its efficiency means nothing and is printed as null
(tools/scaling_probe.py gives the overhead such a mesh measures).

    python3 -m waifu2x_torch.tools.bench_sharded --mesh 1x4
    python3 -m waifu2x_torch.tools.bench_sharded --device cpu --mesh 2x4

--device cpu runs the plain versions on CPU positions at 48 x 64 frames, to
rehearse: no device numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def run(mesh_shape, batch: int, size, iters: int, dev: torch.device) -> dict:
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.parallel import mesh as w2x_mesh
    from waifu2x_torch.parallel import multihost
    from waifu2x_torch.parallel.fast_sharded import (convert_batch_on_mesh,
                                                     make_mesh)
    from waifu2x_torch.pipeline import FastStack
    from waifu2x_torch.utils.timing import card_line

    dp, sp = mesh_shape
    n = dp * sp
    if dev.type == "cpu":
        w2x_mesh.CPU_DEVICES = max(w2x_mesh.CPU_DEVICES, n)
    cards = w2x_mesh.local_devices(dev)
    devices = [cards[i % len(cards)] for i in range(n)]
    virtual = len(set(devices)) < n   # shards that share a device
    mesh = make_mesh(mesh_shape, devices)
    h, w = size
    fast = FastStack.build(init_params(0), scale_input=True,
                           dtype=torch.float32 if dev.type == "cpu"
                           else torch.bfloat16, device=dev)
    gen = torch.Generator().manual_seed(0)
    batch = max(dp, batch - batch % dp)
    yuv = torch.rand((batch, h, w, 3), generator=gen).to(dev)
    base_mesh = make_mesh((1, 1), cards[:1])
    yuv_base = yuv[:max(1, batch // dp), :, :w // sp].contiguous()
    base = multihost.measure_throughput(
        lambda x: convert_batch_on_mesh(x, fast, base_mesh), yuv_base,
        yuv_base.shape[0] * 4 * h * (w // sp), iters=iters)
    report = multihost.measure_throughput(
        lambda x: convert_batch_on_mesh(x, fast, mesh), yuv,
        batch * 4 * h * w, iters=iters, baseline_mp_per_s=base.mp_per_s,
        devices=n)
    eff = report.efficiency
    return {
        "metric": f"megapixels/sec, sharded 2x step (mesh {dp}x{sp}, batch "
                  f"{batch}, {h}x{w} frames, host clock between "
                  f"synchronisations)",
        "value": report.mp_per_s,
        "unit": "MP/s",
        "mesh": [dp, sp],
        "devices": len(set(devices)),
        "virtual": virtual,
        "baseline_1dev_mp_per_s": base.mp_per_s,
        "efficiency_vs_1dev": None if virtual or eff is None else eff,
        "card": card_line(dev),
    }


def main(argv=None) -> int:
    from waifu2x_torch.pipeline import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, metavar="DPxSP",
                    help="mesh shape, e.g. 2x4 (default: 1 x the cards)")
    ap.add_argument("--batch", type=int, default=2,
                    help="frames per step (global, split over dp)")
    ap.add_argument("--size", default="2160x3840",
                    help="frame size HxW (low-res; the output is 2x)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
    else:
        shape = (1, torch.cuda.device_count() if dev.type == "cuda" else 1)
    h, w = (int(v) for v in args.size.split("x"))
    if dev.type == "cpu":   # the plain versions: a small frame
        h, w = min(h, 48), min(w, 64)
    print(json.dumps(run(shape, args.batch, (h, w), args.iters, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
