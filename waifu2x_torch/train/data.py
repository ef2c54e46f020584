"""Training-pair generation (the port's own copy of the JAX package's
train/data.py; numpy + cv2, with PIL for JPEG where cv2 is missing, and no
torch: batches are numpy, and the training loop moves them to the device).
The counterpart of the reference's pairwise_transform.lua
(appendix/waifu2x-nocuda/lib/pairwise_transform.lua).

Host-side (numpy + cv2 JPEG codec), feeding device batches:

  * scale pairs (pairwise_transform.scale, lua:7-67): random crop ->
    random flip -> optional RGB color-scale augment U(0.8,1.2) ->
    2x box-downscale -> optional JPEG noise -> upscale back -> Y planes;
    target is the crop's Y center-cropped by the model offset.
  * jpeg pairs (pairwise_transform.jpeg, lua:68-143): noise level 1 uses a
    single recompression at quality U(65,85); level 2 branches between one
    U(27,80) pass, two passes (q1=U(32,40), q2=q1-5), or three passes
    (q1=U(47,70), q1-10, q1-20) with probabilities 0.4/0.3/0.3.

Note the training colorspace uses the PROPER rgb2yuv (the Lua trainer's
image.rgb2yuv on RGB data); the BGR-order quirk exists only in the C++
converter's inference path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


_YROW = np.array([0.299, 0.587, 0.114], np.float32)


def rgb_luma(img_rgb_f32: np.ndarray) -> np.ndarray:
    """Y of image.rgb2yuv (proper RGB order)."""
    return img_rgb_f32 @ _YROW


def box_downscale2(img: np.ndarray) -> np.ndarray:
    """2x box filter downscale (the 'Box' entry of the Lua filter pool)."""
    h, w = img.shape[:2]
    h2, w2 = h // 2, w // 2
    img = img[: h2 * 2, : w2 * 2]
    return img.reshape(h2, 2, w2, 2, *img.shape[2:]).mean(axis=(1, 3))


def _blackman_taps() -> np.ndarray:
    # 4-tap separable kernel for factor-2 decimation: blackman-windowed
    # sinc sampled at x = +-0.25, +-0.75 (output-space units, support 1)
    x = np.array([-0.75, -0.25, 0.25, 0.75])
    w = (np.sinc(x) * (0.42 + 0.5 * np.cos(np.pi * x)
                       + 0.08 * np.cos(2 * np.pi * x)))
    return (w / w.sum()).astype(np.float32)


_BLACKMAN = _blackman_taps()


def blackman_downscale2(img: np.ndarray) -> np.ndarray:
    """2x Blackman-filter downscale — the second entry of the Lua
    downscale filter pool (pairwise_transform.lua:15-22 picks a random
    filter from {"Box", "Blackman"} per pair; graphicsmagick's Blackman
    is the windowed-sinc family — this is the standard 4-tap separable
    form). A slightly wider, softer decimation than box (all-positive
    taps ~[0.014, 0.486, 0.486, 0.014]), so a model trained on the pool
    sees both decimation characters instead of overfitting box's exact
    2-px average."""
    h, w = img.shape[:2]
    h2, w2 = h // 2, w // 2
    img = img[: h2 * 2, : w2 * 2].astype(np.float32)
    pad = np.pad(img, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2),
                 mode="edge")
    t = _BLACKMAN
    rows = sum(t[k] * pad[k: k + 2 * h2: 2] for k in range(4))
    cols = sum(t[k] * rows[:, k: k + 2 * w2: 2] for k in range(4))
    return cols


_DOWNSCALE_FILTERS = {"box": box_downscale2, "blackman": blackman_downscale2}


def _upscale2_nearest(img: np.ndarray) -> np.ndarray:
    return img.repeat(2, axis=0).repeat(2, axis=1)


def jpeg_recompress(img_u8: np.ndarray, quality: int) -> np.ndarray:
    """One JPEG encode/decode round (gm toBlob/fromBlob in the Lua)."""
    if not _HAS_CV2:  # pragma: no cover
        from io import BytesIO
        from PIL import Image
        buf = BytesIO()
        Image.fromarray(img_u8).save(buf, "JPEG", quality=int(quality))
        buf.seek(0)
        return np.asarray(Image.open(buf).convert("RGB"))
    ok, enc = cv2.imencode(".jpg", img_u8[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    assert ok
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]


def _jpeg_quality_schedule(level: int, rng: np.random.Generator) -> list[int]:
    """Quality chains per noise level (pairwise_transform.lua:115-142)."""
    if level == 1:
        return [int(rng.integers(65, 86))]
    if level == 2:
        r = rng.random()
        if r > 0.6:
            return [int(rng.integers(27, 81))]
        if r > 0.3:
            q1 = int(rng.integers(32, 41))
            return [q1, q1 - 5]
        q1 = int(rng.integers(47, 71))
        return [q1, q1 - 10, q1 - 20]
    raise ValueError(f"unknown noise level: {level}")


def _random_crop(img: np.ndarray, size: int, rng: np.random.Generator):
    h, w = img.shape[:2]
    yi = int(rng.integers(0, h - size + 1))
    xi = int(rng.integers(0, w - size + 1))
    return img[yi : yi + size, xi : xi + size]


def _random_flip(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    flip = int(rng.integers(1, 5))
    if flip == 1:
        return img[:, ::-1]
    if flip == 2:
        return img[::-1]
    if flip == 3:
        return img[::-1, ::-1]
    return img


def _color_augment(img_u8: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    scale = rng.uniform(0.8, 1.2, size=3).astype(np.float32)
    f = img_u8.astype(np.float32) / 255.0 * scale
    return (np.clip(f, 0, 1) * 255.0).astype(np.uint8)


@dataclasses.dataclass
class PairOptions:
    crop_size: int = 128            # settings.lua crop_size
    offset: int = 7                 # settings.lua block_offset
    color_augment: bool = True
    noise: bool = False             # add JPEG noise to scale pairs
    noise_ratio: float = 0.5
    downscale_filters: tuple = ("box",)   # per-pair random pick from the
    #   pool, pairwise_transform.lua:15-22 ({"Box","Blackman"} upstream);
    #   default box-only preserves the r1-r4 recipe


def scale_pair(src_rgb_u8: np.ndarray, rng: np.random.Generator,
               opts: PairOptions = PairOptions()):
    """One (input, target) Y-plane pair for 2x-SR training."""
    y_img = _random_crop(src_rgb_u8, opts.crop_size, rng)
    y_img = _random_flip(y_img, rng)
    if opts.color_augment:
        y_img = _color_augment(y_img, rng)
    pool = opts.downscale_filters
    # single-entry pools skip the RNG draw so the default recipe's
    # stream stays byte-identical to rounds 1-4 at a given seed
    filt = pool[0] if len(pool) == 1 else pool[int(rng.integers(len(pool)))]
    x_img = _DOWNSCALE_FILTERS[filt](y_img.astype(np.float32))
    x_u8 = np.clip(np.rint(x_img), 0, 255).astype(np.uint8)
    if opts.noise and rng.random() < opts.noise_ratio:
        x_u8 = jpeg_recompress(x_u8, int(rng.integers(70, 91)))
    x_img = _upscale2_nearest(x_u8.astype(np.float32))
    x = rgb_luma(x_img / np.float32(255.0))
    y = rgb_luma(y_img.astype(np.float32) / np.float32(255.0))
    k = opts.offset
    return x.astype(np.float32), y[k:-k, k:-k].astype(np.float32)


def jpeg_pair(src_rgb_u8: np.ndarray, level: int, rng: np.random.Generator,
              opts: PairOptions = PairOptions()):
    """One (input, target) Y-plane pair for denoise training."""
    y_img = src_rgb_u8
    if opts.color_augment:
        y_img = _color_augment(y_img, rng)
    x_img = y_img
    for q in _jpeg_quality_schedule(level, rng):
        x_img = jpeg_recompress(x_img, q)
    # crop the same window from both, then flip both identically
    h, w = y_img.shape[:2]
    yi = int(rng.integers(0, h - opts.crop_size + 1))
    xi = int(rng.integers(0, w - opts.crop_size + 1))
    sl = np.s_[yi : yi + opts.crop_size, xi : xi + opts.crop_size]
    y_c, x_c = y_img[sl], x_img[sl]
    flip = int(rng.integers(1, 5))
    if flip == 1:
        y_c, x_c = y_c[:, ::-1], x_c[:, ::-1]
    elif flip == 2:
        y_c, x_c = y_c[::-1], x_c[::-1]
    elif flip == 3:
        y_c, x_c = y_c[::-1, ::-1], x_c[::-1, ::-1]
    x = rgb_luma(x_c.astype(np.float32) / np.float32(255.0))
    y = rgb_luma(y_c.astype(np.float32) / np.float32(255.0))
    k = opts.offset
    return x.astype(np.float32), y[k:-k, k:-k].astype(np.float32)


def make_batch(images: list[np.ndarray], batch_size: int, kind: str,
               rng: np.random.Generator, opts: PairOptions = PairOptions(),
               noise_level: int = 1):
    """Assemble an NHWC f32 device batch of training pairs."""
    xs, ys = [], []
    for _ in range(batch_size):
        src = images[int(rng.integers(0, len(images)))]
        if kind == "scale":
            x, y = scale_pair(src, rng, opts)
        elif kind == "noise":
            x, y = jpeg_pair(src, noise_level, rng, opts)
        else:
            raise ValueError(f"unknown pair kind: {kind}")
        xs.append(x)
        ys.append(y)
    return (np.stack(xs)[..., None], np.stack(ys)[..., None])
