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

With a mesh (mesh=, a parallel.mesh_pipeline.make_mesh3 mesh) every
dispatch runs the composed chain sharded over it (MeshPipeline): frames
over "dp", image rows and columns over "dy" and "sp". Each position's u8
result copies into pinned host memory of its own, each card records an
event after its copies, and a pending batch keeps those buffers until it is
retired (mesh.HostCopy). Odd-sized frames ride the mesh padding.

process_paths converts image files through the port's host I/O (io.py)
and can resume from a frame cursor (train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from waifu2x_torch import io as w2x_io
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
from waifu2x_torch.parallel import mesh as w2x_mesh
from waifu2x_torch.train.checkpoint import load_frame_cursor, save_frame_cursor
from waifu2x_torch.utils import trace
from waifu2x_torch.utils.logging import get_logger

log = get_logger("stream")


def _to_yuv_batch(bgr_u8: torch.Tensor) -> torch.Tensor:
    return bgr_to_yuv(u8_to_unit_f32(bgr_u8))


def _to_bgr_u8_batch(yuv: torch.Tensor) -> torch.Tensor:
    return saturate_cast_u8(yuv_to_bgr(yuv))


def resolve_stream_mesh(spec, device="cuda"):
    """Config.mesh_shape() output -> a ("dp", "dy", "sp") mesh or None (one
    device), over parallel.mesh.local_devices(device). "auto" is pure frame
    data-parallelism (dp = every card: no halo traffic, each card converts
    whole frames) on a host with two or more cards, else None; "off" and
    (1, 1, 1) give None; a shape that needs more devices than there are
    logs a warning and gives None."""
    if spec in ("off", (1, 1, 1)):
        return None
    from waifu2x_torch.parallel.mesh_pipeline import make_mesh3
    devices = w2x_mesh.local_devices(device)
    if spec == "auto":
        if torch.device(device).type != "cuda" or len(devices) < 2:
            return None
        return make_mesh3((len(devices), 1, 1), devices)
    n = spec[0] * spec[1] * spec[2]
    if n > len(devices):
        log.warning("mesh %s needs %d devices, have %d; running "
                    "single-device", spec, n, len(devices))
        return None
    return make_mesh3(spec, devices[:n])


@dataclasses.dataclass
class StreamConverter:
    """Stream processor over the conv-stack kernel path.

    fast:       device-ready FastStack (scale model; None for mode="noise").
    batch:      frames per device dispatch (throughput knob; per-shape
                batches are additionally capped by pixel volume).
    depth:      dispatch-ahead depth (>=1; 2 overlaps host & device work).
    fast_noise: FastStack (noise model) for mode "noise"/"noise_scale".
    mode:       scale | noise | noise_scale (reference main.cpp modes).
    device:     where dispatches run without a mesh; the FastStacks'
                weights must be there.
    mesh:       a make_mesh3 ("dp", "dy", "sp") mesh, or None: dispatches
                then run the composed chain sharded over it (MeshPipeline).
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
        self.device = resolve_device(self.device)
        self._mesh_pipe = None
        if self.mesh is not None:
            from waifu2x_torch.parallel.mesh_pipeline import MeshPipeline
            self._mesh_pipe = MeshPipeline(
                self.mesh, fast_scale=self.fast, fast_noise=self.fast_noise,
                mode=self.mode, scale_ratio=2.0)

    # -- per-shape batching ------------------------------------------------

    def _shape_batch(self, h: int, w: int) -> int:
        """Per-dispatch frame cap for one geometry: the same pixel-volume
        bound the banded kernels use (pipeline.BAND_PX; the scale paths
        band rows once a dispatch exceeds it, so capping the batch keeps
        large-frame dispatches at whole frames where possible).

        Scale modes additionally prefer the largest batch that keeps the
        2x step unbanded (the band overlap is recomputed work), floored at
        2 frames so that 4K+ streams keep dispatch amortisation and just
        band.

        On a mesh the rule bounds each device's share: the cap grows with
        the mesh's size, and a batch covers at least the "dp" axis (short
        batches are frame-padded)."""
        if self._mesh_pipe is not None:
            dp = self.mesh.axis_size("dp")
            cap = max(1, self.mesh.size * (4 if self.mode == "noise" else 1)
                      * BAND_PX // max(1, h * w))
            return max(dp, min(max(self.batch, dp), cap))
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
        last) -> (wait, n valid frames, the pinned input, the crop of a
        mesh's output or None). Nothing waits here: wait() waits for the u8
        result's copy into pinned host memory (the CUDA event after it; on a
        mesh, mesh.HostCopy's events) and returns it as numpy. A
        "w2x.stream.dispatch" span holds it: frames valid and padded, bytes
        copied to the device and back, pinned buffers allocated."""
        with trace.span("w2x.stream.dispatch", on=self.device,
                        frames=len(frames), padded=nbatch) as span:
            return self._enqueue(frames, nbatch, span)

    def _enqueue(self, frames, nbatch: int, span):
        n = len(frames)
        on_card = self.device.type == "cuda"
        host_in = torch.empty((nbatch, *frames[0].shape), dtype=torch.uint8,
                              pin_memory=on_card)
        view = host_in.numpy()
        for k in range(nbatch):   # pad the tail batch with its last frame
            view[k] = frames[min(k, n - 1)]
        if self._mesh_pipe is not None:
            # place the u8 batch on the mesh first, then the YUV map and the
            # chain run sharded; the mesh pads the frame, so retire crops
            pipe = self._mesh_pipe
            h, w = host_in.shape[1], host_in.shape[2]
            out = pipe._chain_u8(pipe._to_yuv(pipe.shard(host_in)), (h, w))
            copy = w2x_mesh.HostCopy(out)
            bufs = list(copy.bufs.values())
            span.set(h2d_bytes=host_in.numel(),
                     d2h_bytes=sum(b.numel() for b in bufs),
                     pinned=sum(b.is_pinned() for b in [host_in, *bufs]))
            s = 1 if self.mode == "noise" else 2
            return copy.wait, n, host_in, (s * h, s * w)
        if not on_card:
            out = self._step(_to_yuv_batch(host_in))
            span.set(h2d_bytes=0, d2h_bytes=0, pinned=0)
            return out.numpy, n, host_in, None
        with torch.cuda.device(self.device):
            out = self._step(_to_yuv_batch(
                host_in.to(self.device, non_blocking=True)))
            host_out = torch.empty(out.shape, dtype=torch.uint8,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        span.set(h2d_bytes=host_in.numel(), d2h_bytes=host_out.numel(),
                 pinned=2)

        def wait() -> np.ndarray:
            done.synchronize()
            return host_out.numpy()

        return wait, n, host_in, None

    # -- ordered streaming -------------------------------------------------

    def process_frames(self, frames: Iterable[np.ndarray]
                       ) -> Iterator[np.ndarray]:
        """u8 BGR frames [h, w, 3] -> converted u8 BGR frames, in input
        order. Sizes may differ across frames: each distinct geometry is
        batched separately, dispatch-ahead keeps the device busy, and
        outputs are re-ordered to input order."""
        bufs: dict[tuple, tuple[list[np.ndarray], list[int]]] = {}
        pending: list[tuple] = []   # (wait, n_valid, host_in, crop, seqs)
        ready: dict[int, np.ndarray] = {}
        next_out = 0

        def retire(entry):
            wait, n_valid, _, crop_hw, seqs = entry
            with trace.span("w2x.stream.wait"):
                out = wait()
            with trace.span("w2x.stream.interleave"):
                host = self._interleave(out)
            if crop_hw is not None:   # mesh-padded dims back to the frame's
                host = host[:, :crop_hw[0], :crop_hw[1]]
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

    def process_paths(self, paths: Sequence[str], out_paths: Sequence[str],
                      jobs: int = 4, checkpoint: str | None = None) -> None:
        """Convert image files: threaded native decode, batched device
        conversion (process_frames), PNG encode.

        checkpoint: optional cursor-file path. The stream is stateless and
        strictly ordered, so resuming is a frame index: after each encoded
        output the cursor advances (atomic rename), and a restarted run
        skips the frames already on disk. (SURVEY §5: the reference has no
        checkpointing; a frame cursor is this pipeline's entire state.)
        """
        start = 0
        if checkpoint is not None:
            start = load_frame_cursor(checkpoint)
            if start >= len(paths):
                return

        def decoded() -> Iterator[np.ndarray]:
            # decode in batch-sized chunks (the native thread pool per
            # chunk), so host memory holds O(batch * depth) frames, not the
            # whole stream: process_frames consumes the iterator lazily
            for c0 in range(start, len(paths), self.batch):
                yield from w2x_io.imread_batch_bgr(
                    list(paths[c0:c0 + self.batch]), jobs=jobs)

        for idx, result in zip(range(start, len(paths)),
                               self.process_frames(decoded())):
            w2x_io.imwrite_bgr(out_paths[idx], result)
            if checkpoint is not None:
                save_frame_cursor(checkpoint, idx + 1)
