"""The composed conversion chain on a ("dp", "dy", "sp") mesh (the
counterpart of the JAX package's parallel/mesh_pipeline.py): what
Converter, StreamConverter and the CLI run on a mesh. The reference's whole
main.cpp chain (noise phase feeding the scale phase, main.cpp:82-100 ->
104-169; ceil(log2 ratio) chained 2x iterations; the final LINEAR shrink,
main.cpp:158-167) split over frames ("dp") and both spatial axes ("dy"
rows x "sp" columns), in place of the reference's sequential 2-D block
tiler (convertRoutine.cpp:100-131).

  * Halos are exchanged per stage (mesh.halo), rows first, then the columns
    of the row-extended block, so corners arrive without diagonal sends.
    Each stage is exact given exact inputs, and every kernel computes each
    pixel in one fixed order (no split-K, no atomics), so the chain equals
    the single-device kernel path (tests/test_torch_mesh_pipeline.py).
  * Each stage's body runs on its position's device with that device's
    copy of the kernel stacks (mesh.replicate of the FastStacks: every
    attribute of ops.stack.StackParams moves).
  * Between scale iterations the polyphase output is interleaved on each
    position (ops/s2d.d2s): a low-res shard maps to a contiguous full-res
    shard, so no data moves.
  * The noise -> scale handoff is the single-device `y=` override: the
    denoised plane keeps the noise kernel's dtype and the scale stage reads
    U/V from the original YUV.
  * The final crop, LINEAR shrink and u8 cast (_finish_raster) gather each
    "dp" row's frames onto that row's first device and run the LINEAR
    resize and _to_bgr_u8 there: the single-device path's per-pixel math.
    JAX partitions that program over the mesh instead (GSPMD); the port
    keeps it per row, which moves the row's full-res YUV to one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from waifu2x_torch.ops.color import bgr_to_yuv, u8_to_unit_f32
from waifu2x_torch.ops.resize import CUBIC, LINEAR, resize, resize2x_phases
from waifu2x_torch.ops.s2d import d2s, d2s_host_cmajor
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.pipeline import (
    BAND_PX,
    FastStack,
    _combine_u8_cmajor,
    _tail_u8_cmajor_noise,
    _to_bgr_u8,
    scale_plan,
)
from waifu2x_torch.utils.logging import get_logger

log = get_logger("mesh")

HALO_SCALE = 4   # low-res px: ceil(7/2) for the stack, 2 for bicubic U/V
HALO_NOISE = 8   # full-res px: the stack's radius 7, kept even so that the
#                  halo-extended shard keeps s2d parity

YUV = ("dp", "dy", "sp", None)
PLANE = ("dp", "dy", "sp")


def make_mesh3(shape: "tuple[int, int, int] | None" = None,
               devices=None) -> m.Mesh:
    """A ("dp", "dy", "sp") mesh: frames x image rows x image columns, over
    `devices` (default: every card)."""
    if devices is None:
        devices = m.local_devices()
    if shape is None:
        shape = (1, 1, len(devices))
    return m.make_mesh(shape, ("dp", "dy", "sp"), devices)


def auto_spatial_shape(n_devices: int, h: int, w: int,
                       min_shard: int = 128) -> "tuple[int, int, int]":
    """(1, dy, sp) for a single-image conversion: as many devices as the
    geometry permits (every spatial shard >= min_shard px on both axes),
    the axes split to keep shards close to the image's aspect."""
    best = (1, 1, 1)
    best_score = -1.0
    for n in range(1, n_devices + 1):
        for dy in range(1, n + 1):
            if n % dy:
                continue
            sp = n // dy
            sh, sw = h / dy, w / sp
            if sh < min_shard or sw < min_shard:
                continue
            # prefer more devices; break ties toward square-ish shards
            score = n * 1000.0 + min(sh, sw) / max(sh, sw)
            if score > best_score:
                best_score, best = score, (1, dy, sp)
    return best


def _halo(x: m.Sharded, k: int, axis_name: str, axis: int) -> m.Sharded:
    """k halo slices on both sides of tensor dim `axis` from the neighbours
    along axis_name; the own edge replicated at the true image borders."""
    return m.halo(x, k, axis_name, axis)


def _halo2d(x: m.Sharded, k: int) -> m.Sharded:
    """[n, h, w, ...] blocks -> [n, h+2k, w+2k, ...]: rows ("dy") first,
    then the columns ("sp") of the row-extended block."""
    return _halo(_halo(x, k, "dy", 1), k, "sp", 2)


@dataclasses.dataclass
class MeshPipeline:
    """The full conversion chain over a ("dp", "dy", "sp") mesh.

    mesh:        from make_mesh3.
    fast_scale:  FastStack (scale model): needed unless mode="noise".
    fast_noise:  FastStack (noise model): needed for the noise modes; its
                 dtype is the handoff's (the `y=` override).
    mode:        noise | scale | noise_scale (main.cpp's modes).
    scale_ratio: the 2x iterations and shrink, by pipeline.scale_plan.
    """

    mesh: m.Mesh
    fast_scale: "FastStack | None" = None
    fast_noise: "FastStack | None" = None
    mode: str = "scale"
    scale_ratio: float = 2.0

    def __post_init__(self):
        if self.mode not in ("noise", "scale", "noise_scale"):
            raise ValueError(f"invalid mode: {self.mode!r}")
        if self.mode != "noise" and self.fast_scale is None:
            raise ValueError(f"mode {self.mode!r} needs fast_scale")
        if self.mode != "scale" and self.fast_noise is None:
            raise ValueError(f"mode {self.mode!r} needs fast_noise")
        if self.mesh.axis_names != ("dp", "dy", "sp"):
            raise ValueError(
                f"MeshPipeline needs a ('dp','dy','sp') mesh (make_mesh3), "
                f"got axes {self.mesh.axis_names}")
        self.iters, self.shrink = (
            scale_plan(self.scale_ratio) if self.mode != "noise" else (0, 0.0))
        # one copy of each stack per distinct device of the mesh
        self._scale = (None if self.fast_scale is None
                       else m.replicate(self.fast_scale, self.mesh))
        self._noise = (None if self.fast_noise is None
                       else m.replicate(self.fast_noise, self.mesh))
        self._warned_volume = False

    # -- stages -------------------------------------------------------------

    def _noise_y(self, yuv: m.Sharded) -> m.Sharded:
        """Denoise: f32 YUV [N, H, W, 3] -> the Y plane [N, H, W] in the
        noise kernel's dtype (noise_y_batch_fast's out_dtype=None
        handoff)."""
        k = HALO_NOISE
        ext = _halo2d(m.shard_map(lambda b: b[..., 0], yuv, spec=PLANE), k)
        return m.shard_map(
            lambda e: self._noise[e.device].noise(e)[:, k:-k, k:-k], ext)

    def _noise_u8(self, yuv: m.Sharded) -> m.Sharded:
        """Noise-only output: f32 YUV [N, H, W, 3] (even block dims) -> u8
        BGR cmajor [N, H/2, W/2, 16], noise_batch_u8_fused's contract and
        math."""
        k = HALO_NOISE
        ext = _halo2d(m.shard_map(lambda b: b[..., 0], yuv, spec=PLANE), k)

        def body(e, yuv_loc):
            ys = self._noise[e.device].noise_s2d(e)
            return _tail_u8_cmajor_noise(
                ys[:, k // 2:-(k // 2), k // 2:-(k // 2), :], yuv_loc)

        return m.shard_map(body, ext, yuv, spec=YUV)

    def _scale_ext(self, yuv: m.Sharded, y: "m.Sharded | None"):
        """The halo-extended YUV and the stack's input plane (the override
        y's, extended, or the extended YUV's Y)."""
        k = HALO_SCALE
        ext = _halo2d(yuv, k)
        if y is None:
            return ext, m.shard_map(lambda e: e[..., 0], ext, spec=PLANE)
        return ext, _halo2d(y, k)

    def _scale_mid(self, yuv: m.Sharded,
                   y: "m.Sharded | None" = None) -> m.Sharded:
        """One full 2x iteration: f32 YUV [N, h, w, 3] -> f32 YUV
        [N, 2h, 2w, 3], interleaved on each position. `y` threads the
        denoised plane into the first iteration of a noise_scale chain."""
        k = HALO_SCALE
        ext, y_in = self._scale_ext(yuv, y)

        def body(e, yi):
            y_s2d = self._scale[e.device].scale(yi)
            y_s2d = y_s2d[:, k:-k, k:-k, :].to(e.dtype)
            uv = resize2x_phases(e[..., 1:3], CUBIC, h_axis=1)
            uv = uv.transpose(-1, -2)[:, k:-k, k:-k]         # [n,h,w,4,2]
            out = torch.cat([y_s2d[..., None], uv], dim=-1)
            n, h, w = out.shape[:3]
            return d2s(out.reshape(n, h, w, 12))

        return m.shard_map(body, ext, y_in, spec=YUV)

    def _scale_u8(self, yuv: m.Sharded,
                  y: "m.Sharded | None" = None) -> m.Sharded:
        """The last 2x iteration with the dense u8 tail: f32 YUV
        [N, h, w, 3] -> u8 BGR cmajor [N, h, w, 16] (pipeline.
        _tail_u8_cmajor's math; interleave with d2s_host_cmajor)."""
        k = HALO_SCALE
        ext, y_in = self._scale_ext(yuv, y)

        def body(e, yi):
            y_s2d = self._scale[e.device].scale(yi)[:, k:-k, k:-k, :]
            ph = resize2x_phases(e[..., 1:3], CUBIC,
                                 h_axis=1)[:, k:-k, k:-k]     # [n,h,w,2,4]
            n, h, w = ph.shape[:3]
            y2 = y_s2d.to(torch.float32).reshape(n, h, w * 4)
            u2 = ph[..., 0, :].reshape(n, h, w * 4)
            v2 = ph[..., 1, :].reshape(n, h, w * 4)
            return _combine_u8_cmajor(y2, u2, v2, n, h, w)

        return m.shard_map(body, ext, y_in, spec=YUV)

    def _finish_raster(self, yuv: m.Sharded, crop, dsize) -> torch.Tensor:
        """Crop the mesh padding, the final LINEAR shrink where the ratio
        asks for one (main.cpp:158-167) and the u8 cast, one "dp" row at a
        time on the row's first device: u8 BGR [n, H', W', 3] on the mesh's
        first device."""
        n, h, w = crop
        first = self.mesh.devices.flat[0]
        outs = []
        for i in range(self.mesh.axis_size("dp")):
            x = m.gather(yuv, self.mesh.devices[i, 0, 0], dp=i)[:, :h, :w]
            if dsize is not None:
                x = resize(x, dsize, LINEAR, h_axis=1)
            outs.append(_to_bgr_u8(x).to(first))
        return torch.cat(outs)[:n]

    def _fix_pad(self, arr: m.Sharded, crop) -> m.Sharded:
        """Re-replicate the mesh padding from the TRUE image edge after a
        kernel stage. The first edge-pad makes every stage's interior exact,
        but a stage's output in the padding is kernel(replicated input),
        not the replicate of its edge output that the reference's next phase
        pads with (each phase pads its own input, main.cpp:82-169 +
        convertRoutine.cpp:35-36). A chained stage reads those columns as
        halo taps, so without this the last columns and rows drift on
        padded images. Columns first, then rows, as in the JAX package."""
        h, w = crop
        arr = self._fix_axis(arr, w, 2, "sp")
        return self._fix_axis(arr, h, 1, "dy")

    def _fix_axis(self, arr: m.Sharded, true: int, dim: int,
                  axis_name: str) -> m.Sharded:
        """Every slice of `dim` at or past `true` set to slice true - 1,
        which the block at index (true - 1) // size of axis_name holds."""
        size = arr.block_shape[dim]
        if true >= arr.shape[dim]:
            return arr
        mesh = arr.mesh
        a = mesh.axis_names.index(axis_name)
        src_i, src_off = divmod(true - 1, size)
        need = [p for p in mesh.positions() if (p[a] + 1) * size > true]
        got = m.move(arr, [(p[:a] + (src_i,) + p[a + 1:], p,
                            lambda b: b.narrow(dim, src_off, 1))
                           for p in need])
        blocks = dict(arr.blocks)
        for p in need:
            if not mesh.is_local(p):
                continue
            b = blocks[p].clone()
            start = max(0, true - p[a] * size)
            edge = got[(p[:a] + (src_i,) + p[a + 1:], p)]
            b.narrow(dim, start, size - start).copy_(
                edge.expand_as(b.narrow(dim, start, size - start)))
            blocks[p] = b
        return m.Sharded(mesh, arr.spec, arr.shape, blocks)

    def _fixed(self, arr: m.Sharded, h: int, w: int) -> m.Sharded:
        """_fix_pad where there is padding, else arr itself."""
        if arr.shape[1] == h and arr.shape[2] == w:
            return arr
        return self._fix_pad(arr, (h, w))

    def _rewrite_y(self, yuv: m.Sharded, y: m.Sharded) -> m.Sharded:
        def body(b, yl):
            out = b.clone()
            out[..., 0] = yl.to(b.dtype)
            return out
        return m.shard_map(body, yuv, y)

    def _to_yuv(self, u8: m.Sharded) -> m.Sharded:
        return m.shard_map(lambda b: bgr_to_yuv(u8_to_unit_f32(b)), u8)

    # -- padding and placement ---------------------------------------------

    def pad_to_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """Edge-pad [N, H, W, C] so the frames divide "dp" and every spatial
        shard is EVEN on both axes (s2d parity; replicate-padding composes
        with the stack's replicate borders, so cropping back is exact). The
        batch padding repeats the last frame (dropped on the crop)."""
        dp, dy, sp = self.mesh.shape
        n, h, w = x.shape[:3]
        return m.edge_pad(x, (-(-n // dp) * dp, -(-h // (2 * dy)) * (2 * dy),
                              -(-w // (2 * sp)) * (2 * sp)))

    def shard(self, x) -> m.Sharded:
        """Pad a batch [N, H, W, C] (u8 BGR or f32 YUV, numpy or tensor) and
        place it on the mesh ("dp", "dy", "sp", None). The stages run
        unbanded, so each device's share of a dispatch must respect the
        budget the single-device path bands against (pipeline.BAND_PX): a
        larger share logs a warning once."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        arr = self.pad_to_mesh(x)
        n, h, w = arr.shape[:3]
        per_dev = n * h * w // self.mesh.size
        if per_dev > BAND_PX and not self._warned_volume:
            self._warned_volume = True
            log.warning("mesh dispatch holds %.1fM px per device (> the "
                        "%.1fM single-dispatch budget); use 'dy'/'sp' spatial "
                        "axes or smaller batches for frames this large",
                        per_dev / 1e6, BAND_PX / 1e6)
        return m.shard(arr, self.mesh, YUV)

    def min_image_hw(self) -> "tuple[int, int]":
        """The smallest (h, w) this mesh converts: every stage's halo fits
        inside one shard (the first stage binds: noise at full res, or the
        first 2x iteration at low res)."""
        _, dy, sp = self.mesh.shape
        need = HALO_NOISE if self.mode != "scale" else 2 * HALO_SCALE
        return need * dy, need * sp

    # -- the chain ------------------------------------------------------------

    def step_u8_cmajor(self, yuv) -> "tuple[m.Sharded, tuple[int, int, int]]":
        """Throughput step (no shrink; at least one iteration, or noise
        mode): f32 YUV [N, H, W, 3] -> (the sharded u8 cmajor output, the
        (n, out_h, out_w) crop after the d2s_host_cmajor interleave)."""
        n, h, w = yuv.shape[:3]
        out = self._chain_u8(self.shard(yuv), (h, w))
        s = 1 << self.iters
        return out, ((n, h, w) if self.mode == "noise"
                     else (n, s * h, s * w))

    def convert_yuv_raster(self, yuv) -> torch.Tensor:
        """The whole chain with the shrink, raster u8 BGR out on the mesh's
        first device: the path for shrink ratios and iters = 0."""
        return self.convert_yuv_raster_presharded(self.shard(yuv),
                                                  tuple(yuv.shape))

    def convert_bgr_u8(self, bgr_u8: np.ndarray) -> np.ndarray:
        """The whole conversion of a u8 BGR batch [N, H, W, 3]: YUV map,
        chain on the mesh, gather, interleave and crop on the host. Returns
        u8 BGR [N, H', W', 3]."""
        n, h, w = bgr_u8.shape[:3]
        yuv = self._to_yuv(self.shard(bgr_u8))
        if self.shrink == 0.0 and (self.iters >= 1 or self.mode == "noise"):
            host = d2s_host_cmajor(
                m.HostCopy(self._chain_u8(yuv, (h, w))).wait())
            s = 1 if self.mode == "noise" else 1 << self.iters
            return host[:n, :s * h, :s * w]
        return self.convert_yuv_raster_presharded(yuv, (n, h, w)).cpu().numpy()

    def _chain_u8(self, yuv: m.Sharded, hw) -> m.Sharded:
        """step_u8_cmajor on an already padded and sharded f32 YUV batch; hw
        is the image's own (unpadded) size, which _fix_pad needs between
        chained stages."""
        if self.shrink != 0.0 or (self.iters < 1 and self.mode != "noise"):
            raise ValueError("the u8-cmajor chain needs shrink == 0 and at "
                             "least one 2x iteration; use the raster path")
        h, w = hw
        if self.mode == "noise":
            return self._noise_u8(yuv)
        y = None
        if self.mode == "noise_scale":
            y = self._fixed(self._noise_y(yuv), h, w)
        for _ in range(self.iters - 1):
            yuv, y = self._scale_mid(yuv, y), None
            h, w = 2 * h, 2 * w
            yuv = self._fixed(yuv, h, w)
        return self._scale_u8(yuv, y)

    def convert_yuv_raster_presharded(self, yuv: m.Sharded,
                                      orig_shape) -> torch.Tensor:
        n, h, w = orig_shape[:3]
        ch, cw = h, w
        y = None
        if self.mode != "scale":
            y = self._fixed(self._noise_y(yuv), ch, cw)
            if self.mode == "noise":
                yuv, y = self._rewrite_y(yuv, y), None
        for _ in range(self.iters):
            yuv, y = self._scale_mid(yuv, y), None
            ch, cw = 2 * ch, 2 * cw
            yuv = self._fixed(yuv, ch, cw)
        s = 1 << self.iters
        dsize = None
        if self.shrink != 0.0:
            dsize = (int(s * h * self.shrink), int(s * w * self.shrink))
        return self._finish_raster(yuv, (n, s * h, s * w), dsize)
