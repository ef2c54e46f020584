"""One four-tap 128 -> 128 layer with channels or positions in the fast
dimension (the counterpart of the JAX package's tools/tmm_probe.py).

B = 16 images, a grid of (8, 4) cells of (64, 128) outputs, each cell
reading its disjoint (72, 144) block of the input, bf16 x bf16 products with
f32 sums (ops/probe.py: tap_mm, csrc/tmm.cu on wgmma):
  chlane   channels fastest: x [16, 576, 640, 128] -> [16, 512, 512, 128]
  poslane  positions fastest: x [16, 576, 128, 640] -> [16, 512, 128, 512]
Each layout held against its plain version bit for bit (inputs k / 16), and
timed beside its bound (bytes: the 67 x 131 positions of each block that
the taps read and the output, 0.664 ms at 3.35 TB/s, the same for both),
the plain version and two library yardsticks: four bf16 torch.matmul over
the shifted views, and one cuDNN conv2d with a 4 x 4 kernel whose
off-diagonal taps are zero.

    python3 -m waifu2x_torch.tools.tmm_probe            # chlane poslane

Needs a CUDA card. --device cpu runs the plain version on the host's clock,
to rehearse at a small size (--batch 1 --size 32 --tile 8 16 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.ops import probe
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=list(probe.TMM_LAYOUTS),
                    help=f"layouts to run, from {probe.TMM_LAYOUTS}")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512,
                    help="output rows and columns (ny * tr, nx * tc)")
    ap.add_argument("--tile", type=int, nargs=2, default=(64, 128),
                    metavar=("TR", "TC"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = [m for m in args.modes if m not in probe.TMM_LAYOUTS]
    if bad:
        ap.error(f"unknown layouts {bad}; choose from {probe.TMM_LAYOUTS}")
    tr, tc = args.tile
    if args.size % tr or args.size % tc or args.batch < 1:
        ap.error("--size must be a multiple of both tile sides")
    dev = resolve_device(args.device)
    ny, nx = args.size // tr, args.size // tc
    print(f"tmm_probe: {args.batch} x ({ny}, {nx}) cells of {(tr, tc)}; "
          f"{card_line(dev)}", flush=True)
    ok = True
    for layout in args.modes:
        r = probe.measure_tap_mm(layout, args.batch, ny, nx, tr, tc, dev,
                                 args.iters, args.seed)
        print(probe.format_tap_mm_row(r), flush=True)
        if rows is not None:
            rows.append(r)
        ok = ok and r["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
