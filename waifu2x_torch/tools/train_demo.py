"""End-to-end training demo on the port (the counterpart of the JAX
package's tools/train_demo.py): synthetic data -> a trained 7-layer model
-> reference-JSON export -> reload, on the card unless --device cpu.

Pairwise scale- or JPEG-transform batches (train/data.py) from synthetic
art, Adam with the cosine schedule (train/train.py: TrainConfig with
precision "default", TF32 on the card), optional warmup, clipping, EMA and
the int8 layer-6 QAT loss (train/qat.py), a fixed held-out set (seed 777,
the JAX tool's protocol) evaluated with the f32 stack, the best of the
evaluated weights exported through models/weights.save_model_json and
reloaded, and a `.provenance.json` sidecar beside the JSON.

    python -m waifu2x_torch.tools.train_demo --out /tmp/scale.json \\
        [--steps 400] [--init models/scale2.0x_demo.json --qat_mu 4 ...]

--out defaults to the shipped file of the kind (models/<kind>_demo.json),
which the run then replaces.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from waifu2x_torch.train.data import PairOptions, make_batch

REPO = Path(__file__).resolve().parents[2]


def _synth_lineart(rng: np.random.Generator, size: int) -> np.ndarray:
    """Line-art class (gen v2): near-white paper, dark thin strokes —
    manga/sketch structure, waifu2x's actual domain. Thin AA curves are
    exactly what 2x decimation destroys hardest."""
    import cv2
    paper = float(rng.integers(235, 256))
    img = np.full((size, size, 3), paper, np.float32)
    img += rng.uniform(-4, 4, (1, 1, 3)).astype(np.float32)  # slight tint
    ink = float(rng.integers(0, 60))
    n_strokes = int(rng.integers(10, 24))
    for _ in range(n_strokes):
        color = (ink + float(rng.uniform(0, 30)),) * 3
        aa = cv2.LINE_AA if rng.random() < 0.8 else cv2.LINE_8
        th = 1 if rng.random() < 0.7 else 2
        kind = int(rng.integers(0, 3))
        if kind == 0:   # polyline "pen stroke"
            pts = rng.integers(0, size, (int(rng.integers(3, 7)), 2))
            cv2.polylines(img, [pts.astype(np.int32)], False, color, th,
                          lineType=aa)
        elif kind == 1:  # outline ellipse (faces, bubbles)
            c = tuple(int(v) for v in rng.integers(0, size, 2))
            ax = (int(rng.integers(6, size // 3)),
                  int(rng.integers(6, size // 3)))
            cv2.ellipse(img, c, ax, float(rng.uniform(0, 180)), 0, 360,
                        color, th, lineType=aa)
        else:            # hatching: short parallel strokes
            x0, y0 = (int(v) for v in rng.integers(0, size - 24, 2))
            step = int(rng.integers(3, 7))
            ln = int(rng.integers(8, 24))
            ang = rng.uniform(0, np.pi)
            dx, dy = int(np.cos(ang) * ln), int(np.sin(ang) * ln)
            for k in range(int(rng.integers(3, 8))):
                p = (x0 + k * step, y0 + k * step // 2)
                cv2.line(img, p, (p[0] + dx, p[1] + dy), color, 1,
                         lineType=aa)
    if rng.random() < 0.3:   # flat gray fill region (tone)
        tone = (float(rng.integers(120, 220)),) * 3
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        p2 = tuple(int(v) for v in rng.integers(0, size, 2))
        cv2.rectangle(img, p1, p2, tone, -1)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)[:, :, ::-1]


def _synth_text(rng: np.random.Generator, size: int) -> np.ndarray:
    """Text class (gen v2): glyphs at assorted scales on light or dark
    ground — subtitles/speech-bubble content; sub-pixel stroke detail."""
    import cv2
    dark_bg = rng.random() < 0.3
    bg = int(rng.integers(0, 50)) if dark_bg else int(
        rng.integers(215, 256))
    fg_lo, fg_hi = (180, 256) if dark_bg else (0, 80)
    # cv2 5.0's putText requires a u8 canvas
    img = np.full((size, size, 3), bg, np.uint8)
    fonts = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX,
             cv2.FONT_HERSHEY_TRIPLEX, cv2.FONT_HERSHEY_SCRIPT_SIMPLEX]
    chars = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             "0123456789!?.,:;-")
    for _ in range(int(rng.integers(6, 16))):
        s = "".join(chars[int(c)] for c in
                    rng.integers(0, len(chars), int(rng.integers(2, 10))))
        org = (int(rng.integers(0, size)), int(rng.integers(10, size)))
        scale = float(rng.uniform(0.3, 1.4))
        color = (int(rng.integers(fg_lo, fg_hi)),) * 3
        th = 1 if scale < 0.9 else int(rng.integers(1, 3))
        cv2.putText(img, s, org, fonts[int(rng.integers(0, len(fonts)))],
                    scale, color, th, cv2.LINE_AA if rng.random() < 0.8
                    else cv2.LINE_8)
    return img[:, :, ::-1]


def synth_image(rng: np.random.Generator, size: int = 192,
                gen: str = "v1") -> np.ndarray:
    """Anime-adjacent synthetic art: flat-color regions, hard and
    antialiased edges, thin line work, soft 2-D gradients, smooth cloudy
    shading and occasional halftone texture — the structure classes the
    SRCNN must learn to reconstruct under 2x downscaling / JPEG noise.
    (Round 2: widened from the r1 generator — ellipses, polylines, 2-D
    gradients, low-frequency shading, dot screens — which measurably
    raises held-out dB of the shipped demo weights.)

    gen="v2" (round 5) mixes in the two classes the painted generator
    lacks — pure line-art (25%) and rendered text (20%) — per VERDICT r4
    item 6 (generator realism for the scale ceiling)."""
    import cv2
    if gen == "v2":
        r = rng.random()
        if r < 0.25:
            return _synth_lineart(rng, size)
        if r < 0.45:
            return _synth_text(rng, size)
    img = np.zeros((size, size, 3), np.float32)
    img[:] = rng.integers(0, 256, 3)
    # 2-D soft gradient (random direction + strength)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    gdir = rng.uniform(0, 2 * np.pi)
    grad = (np.cos(gdir) * xx + np.sin(gdir) * yy) * rng.uniform(0, 80)
    img += grad[..., None]
    if rng.random() < 0.5:
        # cloudy low-frequency shading: upsampled smoothed noise
        small = rng.random((8, 8, 3)).astype(np.float32)
        cloud = cv2.resize(small, (size, size),
                           interpolation=cv2.INTER_CUBIC)
        img += (cloud - 0.5) * rng.uniform(10, 60)
    for _ in range(14):
        color = tuple(float(c) for c in rng.integers(0, 256, 3))
        kind = int(rng.integers(0, 5))
        p1 = tuple(int(c) for c in rng.integers(0, size, 2))
        p2 = tuple(int(c) for c in rng.integers(0, size, 2))
        aa = cv2.LINE_AA if rng.random() < 0.5 else cv2.LINE_8
        if kind == 0:
            cv2.rectangle(img, p1, p2, color, -1)
        elif kind == 1:
            cv2.circle(img, p1, int(rng.integers(8, size // 3)), color, -1,
                       lineType=aa)
        elif kind == 2:
            ax = (int(rng.integers(6, size // 3)),
                  int(rng.integers(6, size // 3)))
            cv2.ellipse(img, p1, ax, float(rng.uniform(0, 180)), 0, 360,
                        color, -1, lineType=aa)
        elif kind == 3:
            # thin polyline (line work / hair strokes)
            pts = rng.integers(0, size, (int(rng.integers(3, 6)), 2))
            cv2.polylines(img, [pts.astype(np.int32)], False, color,
                          int(rng.integers(1, 3)), lineType=aa)
        else:
            cv2.line(img, p1, p2, color, int(rng.integers(1, 4)),
                     lineType=aa)
    if rng.random() < 0.25:
        # halftone-ish dot screen patch (screentone texture)
        step = int(rng.integers(4, 9))
        r0, c0 = rng.integers(0, size // 2, 2)
        h0 = int(rng.integers(size // 4, size // 2))
        tone = tuple(float(c) for c in rng.integers(0, 256, 3))
        for y in range(r0, min(size, r0 + h0), step):
            for x in range(c0, min(size, c0 + h0), step):
                cv2.circle(img, (x, y), max(1, step // 3), tone, -1)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)[:, :, ::-1]


EVAL_SEED = 777          # held-out corpus seed, disjoint from every
                         # training seed scheme (seed*1000 + 1000 + i)


def build_eval_set(kind: str, noise_level: int, n_images: int = 32,
                   crops_per: int = 8, crop: int = 96, gen: str = "v1",
                   opts=None):
    """Fixed held-out eval protocol (round 4): 32 synthetic images x 8
    crops = 256 (input, target) pairs, drawn from generator seed 777 —
    identical for every run and every model of a kind, so steps-vs-dB
    curves and shipped-weight numbers are comparable across rounds.
    gen/opts select a recipe variant (still seed-fixed, so v2 numbers
    are comparable across v2 runs; the v1 default is THE cross-round
    protocol)."""
    rng = np.random.default_rng(EVAL_SEED)
    imgs = [synth_image(rng, gen=gen) for _ in range(n_images)]
    opts = opts or PairOptions(crop_size=crop)
    prng = np.random.default_rng(EVAL_SEED + 1)
    xs, ys = [], []
    for im in imgs:
        x, y = make_batch([im], crops_per, kind, prng, opts,
                          noise_level=noise_level)
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def snapshot(params):
    """A detached CPU copy of params (what is kept as best and exported)."""
    return tuple({k: v.detach().cpu().clone() for k, v in p.items()}
                 for p in params)


def make_evaluator(xs: np.ndarray, ys: np.ndarray, device):
    """Mean per-sample held-out Y-PSNR (dB, unit peak; per-sample MSE
    floored at 1e-12) and the pooled-MSE dB, through the f32 stack with
    TF32 off (ops.convstack.conv_stack_valid) on `device`. Returns
    ev(params) -> (mean_db, pooled_db)."""
    from waifu2x_torch.ops.convstack import conv_stack_valid

    xd = torch.from_numpy(xs).to(device)

    def ev(params) -> tuple:
        p = tuple({k: v.detach().to(device) for k, v in q.items()}
                  for q in params)
        dbs, sse, npx = [], 0.0, 0
        with torch.no_grad():
            for c0 in range(0, xs.shape[0], 32):
                pred = conv_stack_valid(xd[c0:c0 + 32], p).cpu().numpy()
                err = (pred.astype(np.float64)
                       - ys[c0:c0 + 32].astype(np.float64)) ** 2
                mse = err.mean(axis=(1, 2, 3))
                dbs.extend(10.0 * np.log10(1.0 / np.maximum(mse, 1e-12)))
                sse += err.sum()
                npx += err.size
        return float(np.mean(dbs)), float(10.0 * np.log10(npx / sse))

    return ev


def input_baseline_db(xs: np.ndarray, ys: np.ndarray, offset: int = 7
                      ) -> float:
    """Identity baseline: the (noisy / nearest-upscaled) input vs target —
    the information floor the trained model must beat."""
    xc = xs[:, offset:-offset, offset:-offset].astype(np.float64)
    mse = ((xc - ys.astype(np.float64)) ** 2).mean(axis=(1, 2, 3))
    return float(np.mean(10.0 * np.log10(1.0 / np.maximum(mse, 1e-12))))


def prefetch(images, args, opts, steps: int, workers: int, depth: int = 16):
    """Batches from `workers` host threads (cv2's codecs release the GIL),
    worker i drawing from seed * 1000 + 1000 + i; their order is the
    threads'."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    per = [steps // workers + (i < steps % workers) for i in range(workers)]

    def worker(i, n):
        wrng = np.random.default_rng(args.seed * 1000 + 1000 + i)
        for _ in range(n):
            q.put(make_batch(images, args.batch, args.kind, wrng, opts,
                             noise_level=args.noise_level))
        q.put(end)

    for i, n in enumerate(per):
        threading.Thread(target=worker, args=(i, n), daemon=True).start()
    done = 0
    while done < workers:
        item = q.get()
        if item is end:
            done += 1
            continue
        yield item


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=96)
    ap.add_argument("--kind", default="scale", choices=["scale", "noise"],
                    help="training pair kind (pairwise_transform.{scale,"
                         "jpeg} analogues, train/data.py)")
    ap.add_argument("--noise_level", type=int, default=1, choices=[1, 2])
    ap.add_argument("--images", type=int, default=64,
                    help="synthetic training images to generate")
    ap.add_argument("--imgsize", type=int, default=192,
                    help="synthetic training image side length")
    ap.add_argument("--lr", type=float, default=0.00025,
                    help="peak Adam lr (reference settings.lua: 2.5e-4)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear lr warmup steps")
    ap.add_argument("--clip", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--qat_mu", type=float, default=0.0,
                    help="int8 layer-6 QAT coupling weight (train/qat.py): "
                         "adds mu * MSE(fq_stack, f32_stack) to the loss "
                         "and reports the layer-6 quantisation gap at each "
                         "eval (0 = off)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay of a Polyak-averaged shadow of the "
                         "params (0 = off); the best of final/EMA/"
                         "best-evaluated ships")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="held-out eval interval in steps (0 = only at "
                         "the end)")
    ap.add_argument("--widths", default=None,
                    help="comma-separated layer widths of a non-flagship "
                         "architecture to train on the same data and "
                         "protocol (a diagnostic, not shippable weights)")
    ap.add_argument("--init", default=None,
                    help="warm-start weights (reference-format JSON) "
                         "instead of a random init")
    ap.add_argument("--gen", default="v1", choices=["v1", "v2"],
                    help="synthetic generator: v1 = the painted classes "
                         "(the held-out protocol), v2 adds line-art and "
                         "text classes")
    ap.add_argument("--filters", default="box",
                    help="comma-separated downscale filter pool for scale "
                         "pairs (box,blackman)")
    ap.add_argument("--noise_mix", type=float, default=0.0,
                    help="fraction of scale pairs whose low-res input gets "
                         "a JPEG recompression at q70-90")
    ap.add_argument("--workers", type=int, default=4,
                    help="host synthesis threads")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: models/<kind>_demo name, "
                         "which the run replaces)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base RNG seed: the corpus from `seed`, worker i "
                         "from `seed*1000 + 1000 + i` (batch order is the "
                         "threads')")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.out is None:
        args.out = str(REPO / "models" / (
            "scale2.0x_demo.json" if args.kind == "scale"
            else f"noise{args.noise_level}_demo.json"))

    from waifu2x_torch.models.srcnn import (WAIFU2X_7LAYER, ModelSpec,
                                            init_params)
    from waifu2x_torch.models.weights import load_model_json, save_model_json
    from waifu2x_torch.pipeline import resolve_device
    from waifu2x_torch.train.train import TrainConfig, train_loop

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    train_imgs = [synth_image(rng, size=args.imgsize, gen=args.gen)
                  for _ in range(args.images)]
    opts = PairOptions(crop_size=args.crop,
                       downscale_filters=tuple(args.filters.split(",")),
                       noise=args.noise_mix > 0,
                       noise_ratio=args.noise_mix)

    spec = WAIFU2X_7LAYER
    if args.widths:
        if args.init:
            raise SystemExit("--widths and --init are mutually exclusive: "
                             "the init file fixes the architecture")
        spec = ModelSpec.from_widths(
            [int(v) for v in args.widths.split(",")])
    params0 = (load_model_json(args.init) if args.init
               else init_params(0, spec))
    cfg = TrainConfig(batch_size=args.batch, crop_size=args.crop,
                      precision="default", decay_steps=args.steps,
                      learning_rate=args.lr, warmup_steps=args.warmup,
                      ema_decay=args.ema, clip_norm=args.clip)

    # the fixed held-out protocol: the input baseline, the init, the
    # previously written weights, and a steps-vs-dB curve
    xs, ys = build_eval_set(args.kind, args.noise_level)
    ev = make_evaluator(xs, ys, dev)
    base_db = input_baseline_db(xs, ys)
    prev_db = None
    if os.path.exists(args.out):
        prev_db = ev(load_model_json(args.out))[0]
    init_db = ev(params0)[0]
    print(f"held-out baselines: input {base_db:.2f} dB, "
          f"init {init_db:.2f} dB"
          + (f", previously shipped {prev_db:.2f} dB"
             if prev_db is not None else ""), flush=True)

    # the run's own recipe, where it differs from the v1 protocol
    ev2 = base2_db = prev2_db = None
    if args.gen != "v1" or args.filters != "box" or args.noise_mix > 0:
        xs2, ys2 = build_eval_set(
            args.kind, args.noise_level, gen=args.gen, opts=PairOptions(
                crop_size=96, downscale_filters=tuple(args.filters.split(",")),
                noise=args.noise_mix > 0, noise_ratio=args.noise_mix))
        ev2 = make_evaluator(xs2, ys2, dev)
        base2_db = input_baseline_db(xs2, ys2)
        if os.path.exists(args.out):
            prev2_db = ev2(load_model_json(args.out))[0]
        print(f"v2-recipe held-out: input {base2_db:.2f} dB"
              + (f", previously shipped {prev2_db:.2f} dB"
                 if prev2_db is not None else ""), flush=True)

    curve: list = []
    # best starts as the init, so a diverged run exports the init
    best = {"db": init_db, "step": 0, "params": snapshot(params0),
            "variant": "init"}
    qat_loss = None
    if args.qat_mu > 0:
        from waifu2x_torch.train.qat import l6_quant_gap_db, make_qat_l6_loss
        qat_loss = make_qat_l6_loss(args.qat_mu)
        x_gap = torch.from_numpy(xs[:64]).to(dev)

    def on_eval(step, params, ema):
        variants = [("sgd", params)] + ([("ema", ema)]
                                        if ema is not None else [])
        for variant, p in variants:
            pn = snapshot(p)
            db, pooled = ev(pn)
            pt = {"step": step, "variant": variant,
                  "db": round(db, 3), "pooled_db": round(pooled, 3)}
            gap = ""
            if args.qat_mu > 0:
                g = l6_quant_gap_db(tuple({k: v.to(dev) for k, v in
                                           q.items()} for q in pn), x_gap)
                pt["l6_quant_gap_db"] = round(g, 2)
                gap = f", L6 i8 gap {g:.1f} dB"
            curve.append(pt)
            print(f"  eval @ {step:>6} [{variant}]: {db:.2f} dB "
                  f"(pooled {pooled:.2f}{gap})", flush=True)
            if db > best["db"]:
                best.update(db=db, step=step, params=pn, variant=variant)

    out = train_loop(params0, prefetch(train_imgs, args, opts, args.steps,
                                       max(1, args.workers)),
                     cfg, eval_every=args.eval_every, eval_fn=on_eval,
                     loss=qat_loss, device=dev)
    params, losses = out[0], out[1]
    ema = out[2] if len(out) > 2 else None
    print(f"trained {args.steps} steps: mse {losses[0]:.5f} -> "
          f"{np.mean(losses[-20:]):.5f}")
    if not curve or curve[-1]["step"] != args.steps:
        on_eval(args.steps, params, ema)

    ship = best["params"]
    trained_db, trained_pooled = best["db"], None
    for pt in curve:
        if pt["step"] == best["step"] and pt["variant"] == best["variant"]:
            trained_pooled = pt["pooled_db"]
    print(f"held-out Y-PSNR: input {base_db:.2f} dB -> init "
          f"{init_db:.2f} dB -> shipped {trained_db:.2f} dB "
          f"({best['variant']} @ step {best['step']})")

    ship_v2_db = None
    if ev2 is not None:
        ship_v2_db = ev2(ship)[0]
        print(f"v2-recipe held-out, shipped weights: {ship_v2_db:.2f} dB "
              f"(input {base2_db:.2f}"
              + (f", prev {prev2_db:.2f}" if prev2_db is not None else "")
              + ")")

    save_model_json(args.out, ship)
    reloaded = load_model_json(args.out)
    print(f"exported reference-format weights to {args.out} "
          f"(reloads cleanly: {len(reloaded)} layers, "
          f"reload PSNR {ev(reloaded)[0]:.2f} dB)")
    # the model JSON stays a bare layer array (the reference loader's
    # schema); config, metrics and the curve go in the sidecar
    prov = {
        "script": "waifu2x_torch/tools/train_demo.py",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "kind": args.kind, "noise_level": args.noise_level,
        "steps": args.steps, "batch": args.batch, "crop": args.crop,
        "images": args.images, "imgsize": args.imgsize,
        "workers": args.workers, "seed": args.seed,
        "lr": args.lr, "warmup": args.warmup, "ema_decay": args.ema,
        "clip_norm": args.clip, "qat_mu": args.qat_mu,
        "init": args.init, "widths": args.widths,
        "recipe": {"gen": args.gen, "filters": args.filters,
                   "noise_mix": args.noise_mix},
        "heldout_v2_db": (round(ship_v2_db, 2)
                          if ship_v2_db is not None else None),
        "heldout_v2_input_baseline_db": (round(base2_db, 2)
                                         if base2_db is not None else None),
        "heldout_v2_prev_shipped_db": (round(prev2_db, 2)
                                       if prev2_db is not None else None),
        "eval_protocol": {"images": 32, "crops_per": 8, "crop": 96,
                          "seed": EVAL_SEED,
                          "metric": "mean per-sample Y-PSNR dB (unit peak, "
                                    "f32 stack, TF32 off)"},
        "final_train_mse": float(np.mean(losses[-20:])),
        "heldout_y_psnr_db": round(trained_db, 2),
        "heldout_pooled_db": trained_pooled,
        "heldout_input_baseline_db": round(base_db, 2),
        "heldout_y_psnr_untrained_db": round(init_db, 2),
        "heldout_prev_shipped_db": (round(prev_db, 2)
                                    if prev_db is not None else None),
        "shipped_variant": f"{best['variant']}@{best['step']}",
        "curve": curve,
    }
    with open(args.out + ".provenance.json", "w") as f:
        json.dump(prov, f, indent=1)
    print(f"provenance -> {args.out}.provenance.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
