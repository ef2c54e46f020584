"""The ns1080 noise -> scale chain by its parts and band variants (the
counterpart of the JAX package's tools/ns1080_probe.py).

Times, with CUDA events after a warm-up, the chain as the port runs it
(noise_y_batch_fast handed to scale2x_batch_u8_fused's y=, both stacks
bf16, init_params(0)'s weights) and its two halves alone, on random f32
YUV frames of 1080 x 1920, under the JAX tool's band settings and at
batch 4, 6 and 8, in output MP/s (the 2x frames, 2160 x 3840).

Two differences from the JAX tool, printed with every line:
  * its "safe" variants set the Mosaic knob XCOL_SAFE, which has no
    counterpart on the card (ROADMAP.md drops it): they run as the plain
    variants do;
  * the port caps the rows of one dispatch by BAND_PX (pipeline.py:
    _band_rows, _noise_band_rows), so a band setting the JAX tool calls
    unbanded may run in bands here: each line gives the band count and
    rows that really ran.

    python -m waifu2x_torch.tools.ns1080_probe [--iters 12] [--only a,b]

--device cpu --size 24x40 --iters 1 rehearses on the plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.pipeline import (
    FastStack,
    _band_rows,
    _bands,
    _noise_band_rows,
    noise_y_batch_fast,
    resolve_device,
    scale2x_batch_u8_fused,
)
from waifu2x_torch.utils.timing import card_line, time_ms

# (name, part, noise band rows, scale band rows, batch, safe): the JAX
# tool's variants, in its order
VARIANTS = (
    ("noise-only nb=1024 (2 bands)", "noise", 1024, None, 4, False),
    ("noise-only nb=2304 (unbanded)", "noise", 2304, None, 4, False),
    ("scale-only sb=512 (3 bands)", "scale", None, 512, 4, False),
    ("scale-only sb=540 (2 bands)", "scale", None, 540, 4, False),
    ("scale-only sb=1152 unbanded", "scale", None, 1152, 4, True),
    ("chain bench (nb1024 sb512)", "chain", 1024, 512, 4, False),
    ("chain nb2304 sb512", "chain", 2304, 512, 4, False),
    ("chain nb2304 sb540", "chain", 2304, 540, 4, False),
    ("chain nb2304 sb1152 safe", "chain", 2304, 1152, 4, True),
    ("chain b6 nb1024 sb540", "chain", 1024, 540, 6, False),
    ("chain b8 nb1024 sb540", "chain", 1024, 540, 8, False),
)


def bands_run(h: int, rows: int) -> int:
    """How many bands a plane of h rows runs in at `rows` rows a band."""
    return 1 if h <= rows else len(list(_bands(h, rows)))


def main(argv=None, results=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run")
    ap.add_argument("--size", default="1080x1920", help="HxW of a frame")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.size.split("x"))

    params = init_params(0)
    fast = FastStack.build(params, True, torch.bfloat16, dev)
    fast_n = FastStack.build(params, False, torch.bfloat16, dev)
    rng = np.random.default_rng(0)
    print(f"ns1080 chain parts, {h} x {w} frames, bf16 stacks; "
          f"{card_line(dev)}; the safe variants run as the plain ones "
          f"(XCOL_SAFE is a Mosaic knob)", flush=True)

    def fn_of(part, nb, sb):
        if part == "noise":
            return lambda x: noise_y_batch_fast(x[..., 0], fast_n,
                                                band_rows=nb)
        if part == "scale":
            return lambda x: scale2x_batch_u8_fused(x, fast, band_rows=sb)
        return lambda x: scale2x_batch_u8_fused(
            x, fast, band_rows=sb,
            y=noise_y_batch_fast(x[..., 0], fast_n, band_rows=nb))

    for name, part, nb, sb, batch, safe in VARIANTS:
        if args.only and name not in args.only.split(","):
            continue
        x = torch.from_numpy(rng.random((batch, h, w, 3),
                                        dtype=np.float32)).to(dev)
        bands = []
        if nb is not None:
            rows = _noise_band_rows(nb, batch, w)
            bands.append(f"noise {bands_run(h, rows)} x {min(rows, h)} rows")
        if sb is not None:
            rows = _band_rows(sb, batch, w)
            bands.append(f"scale {bands_run(h, rows)} x {min(rows, h)} rows")
        t0 = time.perf_counter()
        ms = time_ms(lambda _: fn_of(part, nb, sb)(x), dev, args.iters)
        mp = batch * 4 * h * w / 1e6
        row = {"name": name, "batch": batch, "safe": safe, "ms": ms,
               "mp_per_s": mp / ms * 1e3, "bands": ", ".join(bands),
               "host_s": time.perf_counter() - t0}
        print(f"{name:34s} b={batch} safe={int(safe)}: {ms:8.2f} ms/batch "
              f"= {row['mp_per_s']:7.1f} MP/s ({row['bands']}; "
              f"{row['host_s']:.1f} s with the warm-up)", flush=True)
        if results is not None:
            results.append(row)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
