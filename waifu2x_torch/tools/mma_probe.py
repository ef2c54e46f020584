"""The ceiling of the tensor-core layers' inner loop: P back-to-back
[M, 128] x [128, 128] bf16 products summed in f32 registers (the counterpart
of the JAX package's tools/vmem_bound_probe.py).

Runs ops.stack.mma_chain, the kernel `mma_chain` of csrc/mma.cu: the same
shared-memory descriptors, cp.async ring and wgmma steps as layers 2-6
(conv3x3_bias_leaky_mma), without a window, taps or an epilogue. Each block
keeps 256 rows of x in shared memory and streams the P weight matrices
through two buffers, so its TFLOP/s is what that inner loop can reach when
nothing else is in its way: layer 6 (K = 9 x 128 per output, the same N)
cannot be faster per multiply-add. It is also where an operand layout is
settled: a wrong descriptor stride or fragment index shows here as a wrong
product of two random matrices, with no convolution around it.

The JAX probe asks whether accumulating into a scratch buffer in fast
memory (a read-modify-write per product) costs more than the products. That
question has no meaning here: the sums live in registers from the first
product to the last, so only its "value" style exists.

Holds the kernel against its plain version (torch.matmul on f32 copies,
summed in f32; max |diff| <= 1e-4 of the largest output, the two summing in
another order), then times kernel, plain version and one library call for
the same function (one bf16 matmul with the P products merged into K).

    python3 -m waifu2x_torch.tools.mma_probe            # 270,336 rows, P = 64
    python3 -m waifu2x_torch.tools.mma_probe --rows 4096 --products 8

Needs a CUDA card. --device cpu runs the plain version on the host's clock,
to rehearse the script at a small size; those are no device times.
"""

from __future__ import annotations

import argparse
import sys

import torch

from waifu2x_torch.ops import stack
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line, time_ms

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
REL_TOL = 1e-4


def make_inputs(rows: int, products: int, seed: int, dev: torch.device):
    """(x [rows, 128] bf16, w [products, 128, 128] bf16) from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((rows, 128), generator=gen) - 0.5).to(dev, torch.bfloat16)
    w = ((torch.rand((products, 128, 128), generator=gen) - 0.5) * 0.25).to(
        dev, torch.bfloat16)
    return x, w


def run(rows: int, products: int, iters: int, seed: int,
        dev: torch.device) -> dict:
    """Check and time the probe; returns its numbers (ms are device times
    on a card, the host's clock on the CPU)."""
    x, w = make_inputs(rows, products, seed, dev)
    wp = stack.pack_chain(w)
    got = stack.mma_chain(x, wp)
    ref = stack.mma_chain_plain(x, wp)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    del got, ref
    flops = 2 * rows * 128 * 128 * products
    moved = x.numel() * 2 + w.numel() * 2 + rows * 128 * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    xk = x.repeat(1, products)                 # the products merged into K
    wk = w.reshape(products * 128, 128)
    return {
        "rows": rows, "products": products, "max_abs_err": err,
        "max_abs_ref": scale, "ok": err <= REL_TOL * scale,
        "ms": time_ms(lambda _: stack.mma_chain(x, wp), dev, iters),
        "plain_ms": time_ms(lambda _: stack.mma_chain_plain(x, wp), dev,
                             max(1, iters // 2)),
        "library_ms": time_ms(lambda _: torch.matmul(xk, wk), dev, iters),
        "flops": flops, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256 * 132 * 8,
                    help="rows of x, a multiple of 256 (256 per block)")
    ap.add_argument("--products", type=int, default=64,
                    help="P, the products summed per output")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.rows < 256 or args.rows % 256 or args.products < 1:
        ap.error("--rows must be a positive multiple of 256 and "
                 "--products at least 1")

    dev = resolve_device(args.device)
    r = run(args.rows, args.products, args.iters, args.seed, dev)
    print(f"mma_chain, {r['rows']} x 128 times {r['products']} x [128, 128] "
          f"bf16, f32 sums; {card_line(dev)}", flush=True)
    print(f"max |kernel - plain| = {r['max_abs_err']:.3e} (largest output "
          f"{r['max_abs_ref']:.3f}, bar {REL_TOL:g} of it)", flush=True)
    if dev.type == "cuda":
        rate = r["flops"] / r["ms"] / 1e9
        print(f"kernel {r['ms']:.3f} ms = {rate:.1f} TFLOP/s = "
              f"{100 * rate * 1e12 / PEAK_BF16_FLOPS:.1f}% of the "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 peak (bound "
              f"{r['bound_ms']:.3f} ms by {r['bound_by']}); plain "
              f"{r['plain_ms']:.3f} ms; one bf16 matmul with K = "
              f"{128 * r['products']} {r['library_ms']:.3f} ms", flush=True)
    else:
        print(f"plain version {r['plain_ms']:.3f} ms on the host", flush=True)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
