"""The work a mesh adds, measured with its shards run one after another (the
counterpart of the JAX package's tools/scaling_probe.py):

    overhead = T(the frame sharded over N positions) / T(one device) - 1

With every position on one card (or on the CPU), the shards run in turn on
one device, so the overhead is exactly the extra work and copying of the
sharded decomposition: the halo rims each shard recomputes, the halo
copies, and the per-shard launches. On N cards each card would then take
(1 + overhead) / N of the one-card time, so

    predicted efficiency ~ 1 / (1 + overhead)

Two paths, each against its analytic halo recompute (the residual is the
copies and the launches):
  * "plane": parallel/sharded.py's non-kernel stack (F.conv2d, TF32 off)
    on one f32 plane over a ("dy", "dx") mesh, halo 7 full-res px, as the
    JAX probe measures;
  * "chain": parallel/mesh_pipeline.py's scale step on the same frame (one
    frame, bf16 kernels, halo 4 low-res px) over (1, dy, dx), against the
    single-device scale2x_batch_u8_fused.

Prints one JSON line, then the halo's bytes against each step's bytes per
device at product sizes (what bounds efficiency across cards).

    python3 -m waifu2x_torch.tools.scaling_probe [--mesh 1x8]
        [--size 512x3840] [--iters 3]
    python3 -m waifu2x_torch.tools.scaling_probe --device cpu --size 64x256

On the card the positions are laid over the cards in turn, all on the one
card of a one-card host; times are the host's clock between
synchronisations of every card. --device cpu rehearses on CPU positions
with the plain versions: no device numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _best_ms(fn, iters: int) -> float:
    from waifu2x_torch.parallel.multihost import synchronize
    fn()                          # warm-up
    synchronize()
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        synchronize()
        dt = (time.perf_counter() - t0) / iters * 1e3
        best = dt if best is None else min(best, dt)
    return best


def run(mesh_shape, size, iters: int, dev: torch.device) -> dict:
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.ops.color import bgr_to_yuv, u8_to_unit_f32
    from waifu2x_torch.parallel import mesh as w2x_mesh
    from waifu2x_torch.parallel import sharded
    from waifu2x_torch.parallel.mesh_pipeline import MeshPipeline, make_mesh3
    from waifu2x_torch.pipeline import FastStack, scale2x_batch_u8_fused
    from waifu2x_torch.utils.timing import card_line

    dy, dx = mesh_shape
    n = dy * dx
    if dev.type == "cpu":
        w2x_mesh.CPU_DEVICES = max(w2x_mesh.CPU_DEVICES, n)
    cards = w2x_mesh.local_devices(dev)
    devices = [cards[i % len(cards)] for i in range(n)]
    h, w = size
    params = tuple({k: v.to(dev) for k, v in p.items()}
                   for p in init_params(0))
    gen = torch.Generator().manual_seed(0)
    y = torch.rand((h, w), generator=gen).to(dev)
    mesh_1 = sharded.make_mesh((1, 1), devices[:1])
    mesh_n = sharded.make_mesh((dy, dx), devices)
    t1 = _best_ms(lambda: sharded.convert_plane_on_mesh(y, params, mesh_1),
                  iters)
    tn = _best_ms(lambda: sharded.convert_plane_on_mesh(y, params, mesh_n),
                  iters)
    off = 7
    sh, sw = -(-h // dy), -(-w // dx)
    plane_recompute = (n * (sh + 2 * off) * (sw + 2 * off)
                       / ((h + 2 * off) * (w + 2 * off)) - 1.0)

    fast = FastStack.build(init_params(0), scale_input=True,
                           dtype=torch.float32 if dev.type == "cpu"
                           else torch.bfloat16, device=dev)
    u8 = torch.randint(0, 256, (1, h, w, 3), generator=gen,
                       dtype=torch.uint8)
    yuv = bgr_to_yuv(u8_to_unit_f32(u8.to(dev)))
    pipe = MeshPipeline(make_mesh3((1, dy, dx), devices), fast_scale=fast)
    c1 = _best_ms(lambda: scale2x_batch_u8_fused(yuv, fast), iters)
    cn = _best_ms(lambda: pipe.step_u8_cmajor(yuv), iters)
    # the stack's work is over its input grown by the 7-px (4 low-res)
    # replicate rim; each shard grows by the 4 halo columns first
    ch, cw = -(-h // (2 * dy)) * 2, -(-w // (2 * dx)) * 2
    chain_recompute = (n * (2 * ch + 16 + 14) * (2 * cw + 16 + 14)
                       / ((2 * h + 14) * (2 * w + 14)) - 1.0)
    out = {
        "metric": f"sharding overhead, {h}x{w} over mesh {dy}x{dx}, the "
                  f"shards run in turn on {len(set(devices))} device(s): "
                  f"total work and copies, not scaling",
        "unit": "fraction of single-device time",
        "card": card_line(dev),
        "plane": {"overhead": tn / t1 - 1.0, "t_single_ms": t1,
                  "t_sharded_ms": tn,
                  "analytic_halo_recompute": plane_recompute,
                  "residual_vs_analytic": tn / t1 - 1.0 - plane_recompute},
        "chain": {"overhead": cn / c1 - 1.0, "t_single_ms": c1,
                  "t_sharded_ms": cn,
                  "analytic_halo_recompute": chain_recompute,
                  "residual_vs_analytic": cn / c1 - 1.0 - chain_recompute},
    }
    for key in ("plane", "chain"):
        out[key]["predicted_efficiency_n_cards"] = 1.0 / (
            1.0 + max(out[key]["overhead"], 0.0))
    return out


def halo_bytes_table() -> list:
    """Per device and 2x step, width-sharded over sp: the halo's bytes (2
    sides x 4 low-res columns x rows x 3 f32 channels) against the step's
    device-memory bytes (~100 B per low-res pixel of the shard: the
    activations, U/V phases and u8 output)."""
    rows = []
    for name, hl, wl in (("1080p", 540, 960), ("4K", 1080, 1920),
                         ("8K", 2160, 3840)):
        for sp in (4, 8):
            halo = 2 * 4 * hl * 3 * 4
            hbm = 100 * hl * (wl // sp)
            rows.append((name, sp, halo, hbm, halo / hbm))
    return rows


def main(argv=None) -> int:
    from waifu2x_torch.pipeline import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1x8", metavar="DYxDX")
    ap.add_argument("--size", default="512x3840", metavar="HxW",
                    help="plane size; the default gives 480-column shards on "
                         "1x8 (4K over 8 cards)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = tuple(int(v) for v in args.mesh.split("x"))
    size = tuple(int(v) for v in args.size.split("x"))
    print(json.dumps(run(shape, size, args.iters, dev)))
    print("# halo bytes per card, 2x step, width-sharded:")
    print("# frame    sp   halo_bytes    hbm_bytes   halo/hbm")
    for name, sp, halo, hbm, frac in halo_bytes_table():
        print(f"#  {name:6} {sp:3} {halo:>12,} {hbm:>12,}   {frac:.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
