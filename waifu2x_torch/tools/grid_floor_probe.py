"""What an (almost) empty kernel costs at the production grid (the
counterpart of the JAX package's tools/grid_floor_probe.py).

B = 16, 512^2, tile (64, 128), grid (16, 8, 4); the output block is
(64, 128, 4) bf16, the input [16, 576, 640, 16] bf16:
  store-only  no input, 1.0 to every output block (probe_store)
  1-fetch     the (64, 128, 16) tile fetched, lanes 0-3 copied out
              (probe_fetch_map)
  4-fetch     the tile and the three tiles right, below and diagonal, all
              fetched whole; out = tile lanes 0-3 + the sum of lane 0 over
              the other three (probe_fetch_reduce, one CUDA block per cell,
              within one bf16 ulp of the plain version: 3 x 8192 f32 terms
              summed in another order)
Each is held against its plain version and timed beside its bound (its
distinct bytes at 3.35 TB/s: the four blocks of neighbouring cells overlap,
so 4-fetch's BlockSpecs name each input byte up to four times), the plain
version and one library call.

    python3 -m waifu2x_torch.tools.grid_floor_probe

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.ops import probe
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    probe.add_args(ap, batch=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = probe.grid_from_args(args, ap)
    print(f"grid_floor_probe: grid {(g.batch, g.ny, g.nx)} of "
          f"{(g.tr, g.tc)} cells; {card_line(dev)}", flush=True)
    ok = probe.run_variants(probe.TOOL_VARIANTS["grid_floor_probe"], g, dev,
                            args.iters, args.seed, rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
