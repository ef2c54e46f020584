"""Streaming / batch serving runtime: u8 BGR frames in, converted u8 BGR
frames out, in input order (the counterpart of the JAX package's
stream.py).

Frames are batched by geometry: each distinct shape has its own batch
buffer, per-shape batch sizes are capped by the same per-dispatch
pixel-volume rule as the banded kernels (pipeline.BAND_PX), and outputs are
re-ordered to input order. The device is kept busy by dispatch-ahead: up to
`depth` batches are in flight before the oldest is read back.

On a CUDA device a dispatch uploads its batch from a pinned host buffer
with a non-blocking copy, enqueues the conversion, copies the u8 result
into a second pinned buffer with a non-blocking copy and records a CUDA
event, all on the current stream; nothing waits. Retiring a batch waits on
its event only, so the host interleave of batch i overlaps the device work
of batches i+1 .. i+depth. A pending batch holds its two pinned buffers
until it is retired, so neither is reused while a copy may still run; with
one stream the caching allocator cannot hand a pending batch's device
memory to a later dispatch before the work that reads it.

Modes mirror the reference CLI (main.cpp:82-169): "scale" (2x), "noise"
(denoise only), "noise_scale" (denoise then 2x). The scale step follows
pipeline.FUSED_TAIL / YDENSE (W2X_TAIL, W2X_YDENSE), and both stacks follow
ops.stack's L6_I8 / L6_WINO (W2X_L6_I8, W2X_L6_WINO).

Not here yet: process_paths and the frame cursor (they need file codecs,
which come with the port's host I/O), and the multi-device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from waifu2x_torch.ops.color import (
    bgr_to_yuv,
    saturate_cast_u8,
    u8_to_unit_f32,
    yuv_to_bgr,
)
from waifu2x_torch.ops.s2d import d2s_host_cmajor
from waifu2x_torch.pipeline import (
    BAND_PX,
    FastStack,
    noise_batch_fast,
    noise_batch_u8_fused,
    noise_y_batch_fast,
    resolve_device,
    scale2x_batch_u8_fused,
)

_MESH_TODO = ("multi-device streams are not ported yet (ROADMAP.md, "
              "A item 14: multi-device)")


def _to_yuv_batch(bgr_u8: torch.Tensor) -> torch.Tensor:
    return bgr_to_yuv(u8_to_unit_f32(bgr_u8))


def _to_bgr_u8_batch(yuv: torch.Tensor) -> torch.Tensor:
    return saturate_cast_u8(yuv_to_bgr(yuv))


def resolve_stream_mesh(spec):
    """Config.mesh_shape() output -> a device mesh or None (one device).
    "off", (1, 1, 1) and "auto" give None: the port runs on one card. An
    explicit larger shape raises NotImplementedError rather than quietly
    running on one device."""
    if spec in ("off", "auto", (1, 1, 1)):
        return None
    raise NotImplementedError(f"mesh {spec}: {_MESH_TODO}")


@dataclasses.dataclass
class StreamConverter:
    """Stream processor over the conv-stack kernel path.

    fast:       device-ready FastStack (scale model; None for mode="noise").
    batch:      frames per device dispatch (throughput knob; per-shape
                batches are additionally capped by pixel volume).
    depth:      dispatch-ahead depth (>=1; 2 overlaps host & device work).
    fast_noise: FastStack (noise model) for mode "noise"/"noise_scale".
    mode:       scale | noise | noise_scale (reference main.cpp modes).
    device:     where dispatches run; the FastStacks' weights must be there.
    mesh:       must be None (see resolve_stream_mesh).
    """

    fast: "FastStack | None"
    batch: int = 8
    depth: int = 2
    fast_noise: "FastStack | None" = None
    mode: str = "scale"
    device: "torch.device | str" = "cuda"
    mesh: "object | None" = None

    @classmethod
    def from_params(cls, scale_params=None, noise_params=None,
                    mode: str = "scale", batch: int = 8, depth: int = 2,
                    quality_noise: bool = True,
                    device="cuda") -> "StreamConverter":
        """Build a stream from reference-format params with the same
        noise-precision policy as the Converter quality surface: in
        noise_scale mode the NOISE stack runs f32 (chained bf16 stacks
        compound their rounding; pipeline._noise_dtype_for). Pass
        quality_noise=False for the throughput trade (bf16 noise stack).
        Constructing the dataclass directly with prebuilt FastStacks is
        the expert surface and applies NO dtype policy."""
        if mode in ("scale", "noise_scale") and scale_params is None:
            raise ValueError(f"mode {mode!r} needs scale_params")
        if mode in ("noise", "noise_scale") and noise_params is None:
            raise ValueError(f"mode {mode!r} needs noise_params")
        dev = resolve_device(device)
        fast = fast_noise = None
        if mode in ("scale", "noise_scale"):
            fast = FastStack.build(scale_params, scale_input=True, device=dev)
        if mode in ("noise", "noise_scale"):
            ndtype = (torch.float32
                      if quality_noise and mode == "noise_scale"
                      else torch.bfloat16)
            fast_noise = FastStack.build(noise_params, scale_input=False,
                                         dtype=ndtype, device=dev)
        return cls(fast=fast, batch=batch, depth=depth,
                   fast_noise=fast_noise, mode=mode, device=dev)

    def __post_init__(self):
        if self.mode not in ("scale", "noise", "noise_scale"):
            raise ValueError(f"invalid mode: {self.mode!r}")
        if self.mode != "noise" and self.fast is None:
            raise ValueError(f"mode {self.mode!r} needs a scale FastStack")
        if self.mode != "scale" and self.fast_noise is None:
            raise ValueError(f"mode {self.mode!r} needs a noise FastStack")
        if self.mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        self.device = resolve_device(self.device)

    # -- per-shape batching ------------------------------------------------

    def _shape_batch(self, h: int, w: int) -> int:
        """Per-dispatch frame cap for one geometry: the same pixel-volume
        bound the banded kernels use (pipeline.BAND_PX; the scale paths
        band rows once a dispatch exceeds it, so capping the batch keeps
        large-frame dispatches at whole frames where possible).

        Scale modes additionally prefer the largest batch that keeps the
        2x step unbanded (the band overlap is recomputed work), floored at
        2 frames so that 4K+ streams keep dispatch amortisation and just
        band."""
        if self.mode == "noise":
            return max(1, min(self.batch, 4 * BAND_PX // max(1, h * w)))
        unbanded = BAND_PX // max(1, h * w)
        return max(1, min(self.batch, max(2, unbanded)))

    def _step(self, yuv: torch.Tensor) -> torch.Tensor:
        if self.mode == "noise":
            # even frames take the dense u8 cmajor tail; odd ones come back
            # as raster BGR through the plane-form noise step
            if yuv.shape[1] % 2 == 0 and yuv.shape[2] % 2 == 0:
                return noise_batch_u8_fused(yuv, self.fast_noise)
            return _to_bgr_u8_batch(noise_batch_fast(yuv, self.fast_noise))
        if self.mode == "noise_scale":
            # the denoised plane keeps the noise kernel's dtype through the
            # handoff; the scale step casts it to its own
            y = noise_y_batch_fast(yuv[..., 0], self.fast_noise,
                                   out_dtype=None)
            return scale2x_batch_u8_fused(yuv, self.fast, y=y)
        return scale2x_batch_u8_fused(yuv, self.fast)

    def _interleave(self, out: np.ndarray) -> np.ndarray:
        # 16-lane outputs are channel-major polyphase u8 (zero-flop host
        # interleave): scale always, noise on even-dim frames; odd-dim
        # noise frames arrive as raster BGR
        return d2s_host_cmajor(out) if out.shape[-1] == 16 else out

    def _dispatch(self, frames: Sequence[np.ndarray], nbatch: int):
        """Enqueue one batch (padded to `nbatch` frames by repeating the
        last) -> (u8 result on the host, the CUDA event after its copy or
        None on the CPU, number of valid frames, the pinned input)."""
        n = len(frames)
        on_card = self.device.type == "cuda"
        host_in = torch.empty((nbatch, *frames[0].shape), dtype=torch.uint8,
                              pin_memory=on_card)
        view = host_in.numpy()
        for k in range(nbatch):   # pad the tail batch with its last frame
            view[k] = frames[min(k, n - 1)]
        if not on_card:
            return self._step(_to_yuv_batch(host_in)), None, n, host_in
        with torch.cuda.device(self.device):
            out = self._step(_to_yuv_batch(
                host_in.to(self.device, non_blocking=True)))
            host_out = torch.empty(out.shape, dtype=torch.uint8,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host_out, done, n, host_in

    # -- ordered streaming -------------------------------------------------

    def process_frames(self, frames: Iterable[np.ndarray]
                       ) -> Iterator[np.ndarray]:
        """u8 BGR frames [h, w, 3] -> converted u8 BGR frames, in input
        order. Sizes may differ across frames: each distinct geometry is
        batched separately, dispatch-ahead keeps the device busy, and
        outputs are re-ordered to input order."""
        bufs: dict[tuple, tuple[list[np.ndarray], list[int]]] = {}
        pending: list[tuple] = []   # (host_out, done, n_valid, host_in, seqs)
        ready: dict[int, np.ndarray] = {}
        next_out = 0

        def retire(entry):
            host_out, done, n_valid, _, seqs = entry
            if done is not None:
                done.synchronize()
            host = self._interleave(host_out.numpy())
            for k, seq in enumerate(seqs[:n_valid]):
                ready[seq] = host[k]

        def drain():
            nonlocal next_out
            while next_out in ready:
                yield ready.pop(next_out)
                next_out += 1

        for seq, frame in enumerate(frames):
            key = frame.shape
            buf, seqs = bufs.setdefault(key, ([], []))
            buf.append(frame)
            seqs.append(seq)
            if len(buf) >= self._shape_batch(*key[:2]):
                pending.append((*self._dispatch(buf, len(buf)), seqs))
                bufs[key] = ([], [])
                if len(pending) > self.depth:
                    retire(pending.pop(0))
                    yield from drain()
        for key, (buf, seqs) in bufs.items():
            if buf:  # tail batches, padded to their shape's batch size
                pending.append(
                    (*self._dispatch(buf, self._shape_batch(*key[:2])), seqs))
        for entry in pending:
            retire(entry)
        yield from drain()
        assert not ready, "stream re-ordering left frames behind"
