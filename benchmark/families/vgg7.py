"""The program's side of nagadomi's 7-layer VGG (vgg_7): the port's stacks,
built by its public set-up (`StreamConverter.from_params`, the product's
precision policy), and the conversion step the window drives, composed as
the stream composes it for the configuration's `mode`: "scale" (the 2x
step), "noise" (the noise step to u8; even frame sizes) or "noise_scale"
(the noise stack's plane handed to the 2x step).

A dispatch: the u8 BGR batch mapped to YUV (`prepare`), then
`scale2x_batch_u8_fused` (after `noise_y_batch_fast` in a chain) or
`noise_batch_u8_fused`, whose u8 result holds a cell of 16 lanes for each
2 x 2 output pixels. The stream's host interleave (`d2s_host_cmajor`) is
not in it: `frames` interleaves on the device, for the check only.
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STRIP_ROWS = 2      # output rows of one low-res (s2d) row: row_psnr_min_db


def interleave(out16):
    """The step's u8 result [N, h, w, 16] (lane c*4 + a*2 + b is channel c
    of output pixel (2i + a, 2j + b); lanes 12-15 unused) -> u8 frames
    [N, 2h, 2w, 3]."""
    n, h, w, _ = out16.shape
    x = out16[..., :12].reshape(n, h, w, 3, 2, 2)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * h, 2 * w, 3)


class Program:
    """The stacks of `cfg` from `weights` (role -> the reference's layers
    [(w [out, in, 3, 3], b [out])] f32), and one dispatch's calls."""

    def __init__(self, cfg: dict, weights: dict, device):
        import torch
        from waifu2x_torch import pipeline
        from waifu2x_torch.ops.color import bgr_to_yuv, u8_to_unit_f32
        from waifu2x_torch.stream import StreamConverter
        from waifu2x_torch.utils.cache import enable_compilation_cache
        enable_compilation_cache(str(ROOT / "waifu2x_torch" / "build"))
        params = {role: [{"w": w.permute(2, 3, 1, 0).contiguous(), "b": b}
                         for w, b in layers]
                  for role, layers in weights.items()}
        self.mode = cfg["mode"]
        conv = StreamConverter.from_params(
            params.get("scale"), params.get("noise"), mode=self.mode,
            device=device)
        built = {"scale": conv.fast, "noise": conv.fast_noise}
        for s in cfg["stacks"]:
            got = str(built[s["role"]].dtype).replace("torch.", "")
            if got != s["dtype"]:
                raise RuntimeError(f"the {s['role']} stack runs in {got}; "
                                   f"the configuration states {s['dtype']}")
        self.fast, self.fast_noise = conv.fast, conv.fast_noise
        self.stacks = [(s["role"], s["dtype"]) for s in cfg["stacks"]]
        self.device = torch.device(device)
        self._unit, self._yuv = u8_to_unit_f32, bgr_to_yuv
        self._noise = pipeline.noise_y_batch_fast
        self._noise_u8 = pipeline.noise_batch_u8_fused
        self._scale = pipeline.scale2x_batch_u8_fused

    def prepare(self, x):
        """u8 BGR [n, h, w, 3] on the device -> f32 YUV [n, h, w, 3]."""
        return self._yuv(self._unit(x))

    def step(self, yuv):
        """f32 YUV [n, h, w, 3] -> (u8 [n, H, W, 16] with lane c*4 + a*2 + b
        channel c of output pixel (2i + a, 2j + b), the denoised Y a chain
        hands on or None)."""
        if self.mode == "noise":
            return self._noise_u8(yuv, self.fast_noise), None
        y = None
        if self.mode == "noise_scale":
            y = self._noise(yuv[..., 0], self.fast_noise, out_dtype=None)
        return self._scale(yuv, self.fast, y=y), y

    def calls(self, batch) -> list:
        """The stack calls of one dispatch, in the configuration's order,
        as the yardstick counts them."""
        from benchmark.counts import StackCall
        return [StackCall(role, dtype, batch.n, batch.h, batch.w)
                for role, dtype in self.stacks]

    def out_px(self, batch) -> int:
        """Pixels of the frames one dispatch returns."""
        scale = 2 if self.fast is not None else 1
        return batch.n * batch.h * batch.w * scale * scale

    def out_shape(self, batch) -> tuple:
        """The shape of step's u8 result for one dispatch: a cell of 16
        lanes for each 2 x 2 output pixels."""
        if self.fast is None:
            return batch.n, batch.h // 2, batch.w // 2, 16
        return batch.n, batch.h, batch.w, 16

    def frames(self, out):
        """step's u8 result -> u8 frames [n, H, W, 3], for the check."""
        return interleave(out)


def build(cfg: dict, weights: dict, device) -> Program:
    return Program(cfg, weights, device)
