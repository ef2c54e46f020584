"""The probes: counterparts of 17 pl.pallas_call sites of the JAX package's
tools. Fifteen move data (stage_time.py, grid_floor_probe.py, dma_probe.py,
dma_probe2.py, dma_probe3.py, fused_strip_probe.py:134, l14_probe.py:145) and
are four CUDA kernels (csrc/probe.cu):

  store         a constant written to every output block
  fetch_map     1 or 4 input blocks, an elementwise map out
  fetch_reduce  1 or 4 input blocks reduced to one f32 per cell, broadcast
                to (or added to) the output block
  l1_mm         a 9-lane block times a (9, 128) weight, lanes 0-3 planar

Each JAX variant is a Variant below, under the name its script gives it,
with its BlockSpecs as Block geometries over a Grid of cells (n, i, j) and
tile (tr, tc). A probe's product is its traffic: the kernel reads every
block a BlockSpec names whole, once per cell, and writes every output block
whole. Beside each wrapper stands a plain PyTorch version of the whole output
array built from views (as_strided, one per BlockSpec) and reshapes over the
grid. A wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting the launch in LAUNCHES; no wrapper falls
back to the plain version when a build or a launch fails.

measure() holds a variant's kernel against its plain version and times the
kernel (one replay of a CUDA graph of back-to-back launches, and the same
launches issued one by one from Python), the plain version and one library
call for the same data movement; the tools under waifu2x_torch/tools/ print
its rows.

The other two (tmm_probe.py:79 and :122) are one four-tap 128 -> 128 layer
with channels or positions in the fast dimension, the tensor-core kernel of
csrc/tmm.cu: tap_mm, tap_mm_plain and measure_tap_mm below.

The last three (accpp_probe.py:127, shift_cost_probe.py:156,
l4_shift_probe.py:130) are the scale stack with variants of its
tensor-core layer (csrc/mma.cu) and of layer 7 (csrc/l7.cu):
stack_scale_pp (two accumulators per layer, B1's function), shift_stack
(the cell offsets of layers 2-7 forced to 0 on one or both axes, wrong by
design) and l4_shift (layers 1-3, then layer 4 by mode). Each has a plain
twin (*_plain).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from waifu2x_torch.ops import _build, stack
from waifu2x_torch.ops.convstack import no_tf32
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import time_ms

PEAK_BYTES = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense (same)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (the same)
# launches of each kernel by its wrapper; the plain versions add none
LAUNCHES = {"store": 0, "fetch_map": 0, "fetch_reduce": 0, "l1_mm": 0,
            "tap_mm": 0}
# fetch_map's launches by the kernel that w2x_probe_fetch_map reports it
# launched: "direct" (probe_map_direct), "planar" (probe_map_planar), "ring"
# (probe_fetch_map, persistent on a TMA ring)
MAP_ROUTES = {"direct": 0, "planar": 0, "ring": 0}
_ROUTE_NAMES = ("direct", "planar", "ring")   # csrc/probe.cu: ROUTE_*
SEED_BYTES = 8 * 128 * 4   # stage_time's (1, 8, 128) f32 seed block
ROTATE_BYTES = 400e6       # timed launches cycle through buffers of 8x L2
RED_THREADS = 288          # csrc/probe.cu's probe_fetch_reduce block
_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "u8": torch.uint8}
_DT_CODE = {"bf16": 0, "f32": 1, "u8": 2}
_MAPS = {"copy": 0, "half": 1, "affine": 2, "zero": 3, "u8": 4,
         "u8_zero": 5, "const0": 6, "lane0": 7}
_REDUCTIONS = {"corner_max": 0, "lane0_sum": 1}
_LANES = {"x16": 16, "x9": 9, "x128": 128, "raw": 1}


def reset_launches() -> None:
    for counts in (LAUNCHES, MAP_ROUTES):
        for k in counts:
            counts[k] = 0


@dataclasses.dataclass(frozen=True)
class Grid:
    """The JAX tools' grid (batch, ny, nx) of (tr, tc) cells."""

    batch: int
    ny: int
    nx: int
    tr: int = 64
    tc: int = 128

    @property
    def cells(self) -> int:
        return self.batch * self.ny * self.nx


def array_shape(kind: str, g: Grid) -> tuple:
    """The input arrays of the tools: the block grid plus one cell each
    way, as 16 lanes ("x16"), 9 ("x9"), the same bytes as 128-lane columns
    ("x128") or a plane ("raw")."""
    h, w = (g.ny + 1) * g.tr, (g.nx + 1) * g.tc
    if kind == "x128":
        return (g.batch, h, w * 16 // 128, 128)
    if kind == "raw":
        return (g.batch, h, w)
    return (g.batch, h, w, _LANES[kind])


@dataclasses.dataclass(frozen=True)
class Block:
    """A BlockSpec: rows x cols x lanes of an input array whose origin in
    cell (n, i, j) is row i*ra + rb, column j*ca + cb."""

    array: str
    rows: int
    cols: int
    lanes: int
    ra: int
    rb: int
    ca: int
    cb: int

    @property
    def nbytes(self) -> int:
        return self.rows * self.cols * self.lanes * 2


def block(kind: str, array: str, g: Grid) -> Block:
    """The tools' blocks: the tile, the tile one cell right, below or
    diagonal ("tile01", "tile10", "tile11"), the 16-column (2 dense
    columns) right stripe, the 8-row lower stripe, their 8 x 16 corner, and
    dma_probe2's (tr, WD // nx, 128) block of the 128-lane array ("wide")."""
    tr, lanes = g.tr, _LANES[array]
    tca = g.tc // 8 if array == "x128" else g.tc   # a tile's array columns
    sw = 2 if array == "x128" else 16              # a right stripe's
    if kind == "wide":
        wc = array_shape(array, g)[2] // g.nx
        return Block(array, tr, wc, lanes, tr, 0, wc, 0)
    di, dj = {"tile": (0, 0), "tile01": (0, 1), "tile10": (1, 0),
              "tile11": (1, 1), "right": (0, 1), "below": (1, 0),
              "diag": (1, 1)}[kind]
    rows = 8 if kind in ("below", "diag") else tr
    cols = sw if kind in ("right", "diag") else tca
    return Block(array, rows, cols, lanes, tr, di * tr, tca, dj * tca)


@dataclasses.dataclass(frozen=True)
class OutSpec:
    """An output block (rows, cols, lanes) of a [B, ny*rows, nx*cols(,
    lanes)] array; its row holds xg pixels of lg lanes, lane-inner
    (x * lg + c) or planar (c * xg + x)."""

    rows: int
    cols: int
    lanes: int
    dtype: str
    form: str
    lg: int
    xg: int

    def shape(self, g: Grid) -> tuple:
        s = (g.batch, g.ny * self.rows, g.nx * self.cols)
        return s + ((self.lanes,) if self.lanes > 1 else ())

    @property
    def nbytes(self) -> int:
        return (self.rows * self.cols * self.lanes
                * _DTYPES[self.dtype].itemsize)


def out_spec(kind: str, g: Grid) -> OutSpec:
    tr, tc = g.tr, g.tc
    return {
        "o4": OutSpec(tr, tc, 4, "bf16", "lanes", 4, tc),
        "dense": OutSpec(tr, 4 * tc, 1, "bf16", "planar", 4, tc),
        "y512r": OutSpec(tr, 4 * tc, 1, "bf16", "lanes", 4, tc),
        "o128": OutSpec(tr, 4, 128, "bf16", "lanes", 128, 4),
        "o2d": OutSpec(tr, tc, 1, "bf16", "lanes", 1, tc),
        "o16c": OutSpec(tr, tc, 16, "u8", "lanes", 16, tc),
        "u8r": OutSpec(tr, 16 * tc, 1, "u8", "lanes", 16, tc),
        "o4f": OutSpec(tr, tc, 4, "f32", "lanes", 4, tc),
        "o16f": OutSpec(tr, tc, 16, "f32", "lanes", 16, tc),
    }[kind]


@dataclasses.dataclass(frozen=True)
class Variant:
    """One probe of a JAX tool: `name` as the tool names it (`label` is
    what it prints), `site` its pallas_call, `kernel` the CUDA kernel, the
    input blocks `ins` of one array kind, the output block and what the
    body computes (`op`; `rep` repeats each source pixel, `seed` reads the
    (1, 8, 128) f32 seed block, `value` is the store's constant). `traces`
    is False for the two dma_probe2.py bodies that JAX cannot trace; the
    port fetches their block whole and writes the zero block."""

    name: str
    label: str
    site: str
    kernel: str
    out: str
    ins: tuple = ()
    array: "str | None" = None
    op: str = "copy"
    rep: int = 1
    seed: bool = False
    value: float = 0.0
    traces: bool = True


_ST, _GF = "tools/stage_time.py", "tools/grid_floor_probe.py"
_FS, _L14 = "tools/fused_strip_probe.py", "tools/l14_probe.py"
_D1, _D2, _D3 = ("tools/dma_probe.py", "tools/dma_probe2.py",
                 "tools/dma_probe3.py")
_X4 = ("tile", "right", "below", "diag")
VARIANTS = {v.name: v for v in (
    Variant("c4", "outonly", f"{_ST}:82", "store", "o4", seed=True),
    Variant("cd", "outdense", f"{_ST}:95", "store", "dense", seed=True),
    Variant("out4f32", "out4f32", f"{_ST}:113", "store", "o4f", seed=True),
    Variant("out16f32", "out16f32", f"{_ST}:113", "store", "o16f",
            seed=True),
    Variant("out16u8", "out16u8", f"{_ST}:113", "store", "o16c", seed=True),
    Variant("cin1", "in16", f"{_ST}:172", "fetch_reduce", "dense", ("tile",),
            "x16", "corner_max"),
    Variant("cin4", "in16x4", f"{_ST}:187", "fetch_reduce", "dense", _X4,
            "x16", "corner_max"),
    Variant("ccat", "outcat", f"{_ST}:203", "fetch_map", "dense", ("tile",),
            "x16", "half"),
    Variant("cin9", "in9", f"{_ST}:220", "fetch_reduce", "dense", ("tile",),
            "x9", "corner_max"),
    Variant("cin9mm", "in9+l1", f"{_ST}:241", "l1_mm", "dense", ("tile",),
            "x9"),
    Variant("store-only", "store-only (0 inputs)", f"{_GF}:100", "store",
            "o4", value=1.0),
    Variant("1-fetch", "1 full fetch operand", f"{_GF}:100", "fetch_map",
            "o4", ("tile",), "x16"),
    Variant("4-fetch", "4 full fetch operands", f"{_GF}:100",
            "fetch_reduce", "o4", ("tile", "tile01", "tile10", "tile11"),
            "x16", "lane0_sum"),
    Variant("lane16_x4", "lane16_x4", f"{_D1}:55", "fetch_map", "o4", _X4,
            "x16"),
    Variant("lane16_x1", "lane16_x1", f"{_D1}:55", "fetch_map", "o4",
            ("tile",), "x16"),
    Variant("lane128", "lane128", f"{_D1}:55", "fetch_map", "o4", ("tile",),
            "x128", rep=8),
    Variant("lane128_x4", "lane128_x4", f"{_D1}:55", "fetch_map", "o4", _X4,
            "x128", rep=8),
    Variant("raw2d", "raw2d", f"{_D1}:157", "fetch_map", "o4", ("tile",),
            "raw"),
    Variant("out4", "out4", f"{_D2}:50", "store", "o4"),
    Variant("out128", "out128", f"{_D2}:50", "store", "o128"),
    Variant("out2d", "out2d", f"{_D2}:50", "store", "o2d"),
    Variant("in16+o128", "in16+o128", f"{_D2}:50", "fetch_map", "o128",
            ("tile",), "x16", "const0", traces=False),
    Variant("in128+o128", "in128+o128", f"{_D2}:50", "fetch_map", "o128",
            ("wide",), "x128", "zero"),
    Variant("raw+o128", "raw+o128", f"{_D2}:50", "fetch_map", "o128",
            ("tile",), "raw", "const0", traces=False),
    Variant("in16+o16c", "in16+o16c", f"{_D2}:50", "fetch_map", "o16c",
            ("tile",), "x16", "u8_zero"),
    Variant("y4", "y4", f"{_D3}:54", "fetch_map", "o4", ("tile",), "x16",
            "affine"),
    Variant("y512r", "y512r", f"{_D3}:54", "fetch_map", "y512r", ("tile",),
            "x16", "affine"),
    Variant("y512n", "y512n", f"{_D3}:54", "fetch_map", "dense", ("tile",),
            "x16"),
    Variant("u8_16", "u8_16", f"{_D3}:54", "fetch_map", "o16c", ("tile",),
            "x16", "u8"),
    Variant("u8_2048r", "u8_2048r", f"{_D3}:54", "fetch_map", "u8r",
            ("tile",), "x16", "u8"),
    Variant("oneblk", "oneblk", f"{_FS}:134", "fetch_map", "o4", ("tile",),
            "x16", "lane0"),
    Variant("xonly", "xonly", f"{_L14}:145", "fetch_map", "o4", _X4, "x16"),
)}
# each tool's variants, in its order
TOOL_VARIANTS = {
    "stage_time": ("c4", "cd", "out4f32", "out16f32", "out16u8", "cin1",
                   "cin4", "ccat", "cin9", "cin9mm"),
    "grid_floor_probe": ("store-only", "1-fetch", "4-fetch"),
    "dma_probe 1": ("lane16_x4", "lane16_x1", "lane128", "lane128_x4",
                    "raw2d"),
    "dma_probe 2": ("out4", "out128", "out2d", "in16+o128", "in128+o128",
                    "raw+o128", "in16+o16c"),
    "dma_probe 3": ("y4", "y512r", "y512n", "u8_16", "u8_2048r"),
    "fused_strip_probe": ("oneblk",),
    "l14_probe": ("xonly",),
}
# the kernels take their f32 sums (9 products; 3 x tr x tc lane-0 terms) in
# another order than the plain versions: make_inputs draws these variants'
# inputs as k / 256 (k = 0..255), so that every sum is exact in any order and
# they too are held bit for bit
SUM_VARIANTS = ("cin9mm", "4-fetch")


def traffic_bytes(v: Variant, g: Grid) -> int:
    """The bytes the variant's BlockSpecs move: each input block read once
    and the output block written once per cell (the seed and weight blocks
    too)."""
    per_cell = sum(block(k, v.array, g).nbytes for k in v.ins)
    per_cell += out_spec(v.out, g).nbytes
    per_cell += SEED_BYTES if v.seed else 0
    per_cell += 9 * 128 * 2 if v.kernel == "l1_mm" else 0
    return per_cell * g.cells


def distinct_bytes(v: Variant, g: Grid) -> int:
    """The bytes the function must move: each input byte that some cell's
    block covers read once (neighbouring cells' blocks overlap in cin4,
    lane16_x4, lane128_x4 and 4-fetch), the seed and weight once, the
    output written once. The bound and the memory-rate check use these."""
    n = out_spec(v.out, g).nbytes * g.cells
    n += (SEED_BYTES if v.seed else 0) + (9 * 128 * 2 if v.kernel == "l1_mm"
                                          else 0)
    if v.ins:
        _, h, w = array_shape(v.array, g)[:3]
        mask = torch.zeros((h, w), dtype=torch.bool)
        for k in v.ins:
            b = block(k, v.array, g)
            for i in range(g.ny):
                for j in range(g.nx):
                    r, c = i * b.ra + b.rb, j * b.ca + b.cb
                    mask[r:r + b.rows, c:c + b.cols] = True
        n += int(mask.sum()) * _LANES[v.array] * 2 * g.batch
    return n


def flops(v: Variant, g: Grid) -> int:
    """The operations of l1_mm's bf16 x bf16 products with f32 sums into
    the 128-lane scratch (2 x 9 x 128 per pixel), which the tensor cores
    could do at PEAK_BF16_FLOPS; the other probes do a few per byte. Every
    probe is bound by its bytes."""
    return 2 * 9 * 128 * g.cells * g.tr * g.tc if v.kernel == "l1_mm" else 0


def make_inputs(v: Variant, g: Grid, seed: int, device) -> dict:
    """The variant's arguments: "x", uniform [0, 1) in bf16 as the tools
    draw it (k / 256 for SUM_VARIANTS); "seed", stage_time's ones; "w", the
    (9, 128) bf16 weight, drawn as k / 256."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, exact):
        if exact:
            return (torch.randint(0, 256, shape, generator=gen, device=dev)
                    .to(torch.bfloat16) / 256)
        return torch.rand(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    args = {}
    if v.array is not None:
        args["x"] = draw(array_shape(v.array, g), v.name in SUM_VARIANTS)
    if v.seed:
        args["seed"] = torch.ones((1, 8, 128), dtype=torch.float32,
                                  device=dev)
    if v.kernel == "l1_mm":
        args["w"] = draw((9, 128), True)
    return args


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def cells(x: torch.Tensor, b: Block, g: Grid) -> torch.Tensor:
    """The block of every cell as one view [B, ny, nx, rows, cols, lanes]
    of the contiguous array x."""
    x4 = x.unsqueeze(-1) if x.dim() == 3 else x
    sn, sh, sw, sl = x4.stride()
    return x4.as_strided(
        (g.batch, g.ny, g.nx, b.rows, b.cols, b.lanes),
        (sn, b.ra * sh, b.ca * sw, sh, sw, sl),
        x4.storage_offset() + b.rb * sh + b.cb * sw)


def _assemble(blocks: torch.Tensor, o: OutSpec, g: Grid) -> torch.Tensor:
    """[B, ny, nx, rows, cols*lanes (or rows, cols, lanes)] -> the array."""
    return blocks.reshape(g.batch, g.ny, g.nx, o.rows, o.cols, o.lanes
                          ).permute(0, 1, 3, 2, 4, 5).reshape(o.shape(g))


def _store_value(v: Variant, seed: "torch.Tensor | None", dtype: str):
    """The constant of a store: value, or 0 + seed[0, 0, 0] in f32 cast to
    the output type (u8 through int32, as the JAX body casts)."""
    if not v.seed:
        return v.value
    s = torch.zeros((), dtype=torch.float32) + seed[0, 0, 0].float().cpu()
    if dtype == "u8":
        return int(s.to(torch.int32).to(torch.uint8))
    return float(s.to(_DTYPES[dtype]))


def store_plain(v: Variant, g: Grid, seed=None, device=None):
    """A store's output on `device` (None: the card, as resolve_device
    gives it)."""
    o = out_spec(v.out, g)
    return torch.full(o.shape(g), _store_value(v, seed, o.dtype),
                      dtype=_DTYPES[o.dtype],
                      device=resolve_device("cuda" if device is None
                                            else device))


def _map(op: str, t: torch.Tensor) -> torch.Tensor:
    if op == "half":
        return t * 0.5
    if op == "affine":
        return t * 0.5 + 1.0
    if op == "zero":
        return t * 0
    if op == "u8":
        return torch.clamp(torch.round(t * 255.0), 0, 255)
    if op == "u8_zero":
        return (t * 0).to(torch.int32)
    return t


def fetch_map_plain(v: Variant, g: Grid, x: torch.Tensor) -> torch.Tensor:
    o = out_spec(v.out, g)
    if v.op == "const0":
        return torch.zeros(o.shape(g), dtype=_DTYPES[o.dtype],
                           device=x.device)
    bs = [block(k, v.array, g) for k in v.ins]
    xs = o.xg // v.rep
    lanes = o.lg if bs[0].lanes > 1 and v.op != "lane0" else 1
    t = cells(x, bs[0], g)[..., :xs, :lanes].float()
    t = t.expand(*t.shape[:-1], o.lg)
    if len(bs) == 4:   # the tile plus its right, lower and diagonal stripes
        t = t + cells(x, bs[1], g)[..., :, 0:1, :o.lg].float()
        t = t + cells(x, bs[2], g)[..., 0:1, :xs, :o.lg].float()
        t = t + cells(x, bs[3], g)[..., 0:1, 0:1, :o.lg].float()
    t = _map(v.op, t.repeat_interleave(v.rep, dim=-2) if v.rep > 1 else t)
    if o.form == "planar":
        t = t.transpose(-1, -2)
    return _assemble(t.to(_DTYPES[o.dtype]), o, g)


def fetch_reduce_plain(v: Variant, g: Grid, x: torch.Tensor) -> torch.Tensor:
    o = out_spec(v.out, g)
    bs = [block(k, v.array, g) for k in v.ins]
    if v.op == "corner_max":
        t = None
        for b in bs:
            m = cells(x, b, g)[..., 0:8, 0:8, :].float().amax(dim=(-3, -2,
                                                                   -1))
            t = m if t is None else t + m
        t = torch.zeros_like(t) + t
        blocks = t[..., None, None, None].expand(
            *t.shape, o.rows, o.cols, o.lanes)
    else:   # lane0_sum
        s = torch.zeros((g.batch, g.ny, g.nx), dtype=torch.float32,
                        device=x.device)
        for b in bs[1:]:
            s = s + cells(x, b, g)[..., 0].float().sum(dim=(-2, -1))
        blocks = (cells(x, bs[0], g)[..., :o.lg].float()
                  + s[..., None, None, None])
    return _assemble(blocks.to(_DTYPES[o.dtype]), o, g)


def l1_mm_plain(v: Variant, g: Grid, x: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The nine products summed in f32 in tap order, the (tr, tc, 128)
    scratch rounded to bf16, its lanes 0-3 planar."""
    o = out_spec(v.out, g)
    a = cells(x, block("tile", v.array, g), g)
    wf = w.float()
    acc = a[..., 0:1].float() * wf[0]
    for k in range(1, 9):
        acc.add_(a[..., k:k + 1].float() * wf[k])
    scratch = acc.to(torch.bfloat16)
    return _assemble(scratch[..., 0:4].transpose(-1, -2), o, g)


def plain(v: Variant, g: Grid, args: dict, device=None) -> torch.Tensor:
    """The plain version of any variant on make_inputs' arguments; a store
    without a seed makes its output on `device` (None: the card; the CPU
    only when asked for)."""
    if v.kernel == "store":
        dev = args["seed"].device if v.seed else device
        return store_plain(v, g, args.get("seed"), dev)
    if v.kernel == "fetch_map":
        return fetch_map_plain(v, g, args["x"])
    if v.kernel == "fetch_reduce":
        return fetch_reduce_plain(v, g, args["x"])
    return l1_mm_plain(v, g, args["x"], args["w"])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_LLP, _PTRP = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_PTR)
_ARGTYPES = {
    "w2x_probe_store": [_PTR, _LLP, _PTR, _INT, ctypes.c_float, _PTR],
    "w2x_probe_fetch_map": [_PTRP, _LLP, _INT, _PTR, _LLP, _INT, _INT, _INT,
                            _INT, _INT, ctypes.POINTER(_INT), _PTR],
    "w2x_probe_fetch_reduce": [_PTRP, _LLP, _INT, _PTR, _LLP, _INT, _INT,
                               _PTR, ctypes.c_longlong, _PTR],
    "w2x_probe_l1_mm": [_PTR, _LLP, _PTR, _PTR, _LLP, _PTR],
}
_TMM_ARGTYPES = {"w2x_tap_mm": [_INT, _PTR, _PTR, _PTR] + [_INT] * 7 + [_PTR]}
_LIBS: dict = {}


def _lib(name: str = "probe") -> ctypes.CDLL:
    """csrc/probe.cu's library (or csrc/tmm.cu's, name "tmm"), built at
    first use and kept for the process."""
    if name not in _LIBS:
        lib = _build.load(name)[0]
        fns = _ARGTYPES if name == "probe" else _TMM_ARGTYPES
        for fn, argtypes in fns.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = lib.w2x_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _lls(vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*vals)


def _in_desc(bs, g: Grid) -> ctypes.Array:
    vals = []
    for b in bs:
        _, h, w = array_shape(b.array, g)[:3]
        vals += [h, w, b.lanes, b.rows, b.cols, b.ra, b.rb, b.ca, b.cb]
    return _lls(vals)


def _out_desc(o: OutSpec, g: Grid) -> ctypes.Array:
    run = o.cols * o.lanes
    return _lls([_DT_CODE[o.dtype], o.rows, run, g.nx * run,
                 g.ny * o.rows * g.nx * run, g.batch, g.ny, g.nx])


def _check_geometry(v: Variant, g: Grid) -> None:
    """What the kernels take: whole 16-byte vectors in every block row and
    output row, output rows in groups of 4, corners of 8 x 8."""
    o = out_spec(v.out, g)
    if g.tr % 8 or g.tc % 16:
        raise ValueError(f"tile {(g.tr, g.tc)}: tr must be a multiple of 8 "
                         f"and tc of 16")
    if (o.cols * o.lanes * _DTYPES[o.dtype].itemsize) % 16:
        raise ValueError(f"{v.name}: an output row of {o.cols * o.lanes} "
                         f"{o.dtype} is not whole 16-byte vectors")
    if v.kernel == "fetch_map" and any(
            n & (n - 1) for n in (o.lg, o.xg, v.rep)):
        raise ValueError(f"{v.name}: the map's lanes, pixels and repeat "
                         f"{(o.lg, o.xg, v.rep)} must be powers of two")
    for k in v.ins:
        b = block(k, v.array, g)
        if (b.cols * b.lanes) % 8 or b.cols == 0:
            raise ValueError(f"{v.name}: a {k} block row of {b.cols} x "
                             f"{b.lanes} bf16 is not whole 16-byte vectors")


def _check(v: Variant, g: Grid, args: dict, out) -> torch.device:
    """Types, shapes and devices of a wrapper's arguments -> the device."""
    _check_geometry(v, g)
    want = {}
    if v.array is not None:
        want["x"] = (array_shape(v.array, g), torch.bfloat16)
    if v.seed:
        want["seed"] = ((1, 8, 128), torch.float32)
    if v.kernel == "l1_mm":
        want["w"] = ((9, 128), torch.bfloat16)
    if set(args) != set(want):
        raise ValueError(f"{v.name} takes {sorted(want)}, got {sorted(args)}")
    devs = set()
    for k, (shape, dtype) in want.items():
        t = args[k]
        if tuple(t.shape) != shape or t.dtype != dtype or not (
                t.is_contiguous()):
            raise ValueError(f"{v.name}: {k} must be contiguous {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        devs.add(t.device)
    if out is not None:
        o = out_spec(v.out, g)
        if (tuple(out.shape) != o.shape(g) or out.dtype != _DTYPES[o.dtype]
                or not out.is_contiguous()):
            raise ValueError(f"{v.name}: out must be contiguous "
                             f"{_DTYPES[o.dtype]} {o.shape(g)}")
        devs.add(out.device)
    if len(devs) > 1:
        raise ValueError(f"{v.name}: arguments on {sorted(map(str, devs))}")
    return devs.pop() if devs else None


def pack_l1_mm(w: torch.Tensor) -> torch.Tensor:
    """The (9, 128) weight as probe_l1_mm's resident B operand: K padded to
    16 by zeros, [k8][n][8] (wp[k8, n, e] = w[8 k8 + e, n]), 4096 bytes."""
    if tuple(w.shape) != (9, 128):
        raise ValueError(f"w must be (9, 128), got {tuple(w.shape)}")
    wk = torch.zeros((16, 128), dtype=w.dtype, device=w.device)
    wk[:9] = w
    return wk.reshape(2, 8, 128).permute(0, 2, 1).contiguous()


def _c_args(v: Variant, g: Grid, args: dict, out: torch.Tensor, sink=None,
            keep: "list | None" = None, route=None) -> tuple:
    """The C entry's arguments but the stream; tensors made here (the
    packed weight) are appended to `keep`. fetch_map's entry sets `route`,
    a ctypes.c_int where given, to the kernel it launched (_ROUTE_NAMES)."""
    o = out_spec(v.out, g)
    od, x = _out_desc(o, g), args.get("x")
    bs = [block(k, v.array, g) for k in v.ins]
    if v.kernel == "store":
        seed = args.get("seed")
        return (out.data_ptr(), od, None if seed is None else
                seed.data_ptr(), 0 if seed is None else SEED_BYTES,
                float(v.value))
    if v.kernel == "l1_mm":
        wp = pack_l1_mm(args["w"])
        if keep is not None:
            keep.append(wp)
        return (x.data_ptr(), _in_desc(bs, g), wp.data_ptr(), out.data_ptr(),
                od)
    ins = (_PTR * len(bs))(*([x.data_ptr()] * len(bs)))
    head = (ins, _in_desc(bs, g), len(bs), out.data_ptr(), od)
    if v.kernel == "fetch_map":
        return head + (int(o.form == "planar"), o.lg, o.xg, v.rep,
                       _MAPS[v.op],
                       None if route is None else ctypes.byref(route))
    return head + (_REDUCTIONS[v.op], o.lg,
                   None if sink is None else sink.data_ptr(),
                   0 if sink is None else sink.numel())


def _prepare(v: Variant, g: Grid, args: dict, out=None, device=None,
             sink=None):
    dev = _check(v, g, args, out) or torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    o = out_spec(v.out, g)
    if out is None:
        out = torch.empty(o.shape(g), dtype=_DTYPES[o.dtype], device=dev)
    keep = [out, args, sink]
    route = ctypes.c_int(-1) if v.kernel == "fetch_map" else None
    cargs = _c_args(v, g, args, out, sink, keep, route)
    lib = _lib()
    fn = getattr(lib, f"w2x_probe_{v.kernel}")

    def launch(_keep=keep) -> None:   # the tensors outlive launch
        # on the stream current at the call, so that a graph captures it
        err = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            msg = lib.w2x_error_string(err).decode()
            raise RuntimeError(f"probe kernel {v.kernel}, {v.name}: {msg}")
        LAUNCHES[v.kernel] += 1
        if route is not None:
            MAP_ROUTES[_ROUTE_NAMES[route.value]] += 1

    return out, launch


def prepare(v: Variant, g: Grid, args: dict, out=None, device=None):
    """Check the arguments once -> (out, launch) for a CUDA run: launch()
    enqueues the kernel on the device's current stream, with its C
    arguments built here, and counts it. The timing loops call launch()
    alone, so that they time the card and not these checks."""
    return _prepare(v, g, args, out, device)


def traffic_sum_plain(v: Variant, g: Grid, x: torch.Tensor) -> int:
    """The sum mod 2^32 of every 32-bit word (two bf16, the lower address
    in the low half) of every block a BlockSpec names, once per cell: what
    probe_fetch_reduce's whole-block pass lands in shared memory. A block
    dropped or read twice changes it (an xor would cancel a block read
    twice)."""
    total = 0
    for k in v.ins:
        b = block(k, v.array, g)
        words = cells(x, b, g).reshape(-1, b.cols * b.lanes).view(
            torch.int32)
        total += int(words.to(torch.int64).sum())
    return total % 2**32


def traffic_sum(v: Variant, g: Grid, args: dict) -> int:
    """probe_fetch_reduce's own traffic sum on make_inputs' arguments: the
    kernel launched with a sink of one word a thread (counted in
    LAUNCHES), the words summed mod 2^32. CPU tensors take
    traffic_sum_plain."""
    if v.kernel != "fetch_reduce":
        raise ValueError(f"{v.name}: the traffic sum is probe_fetch_reduce's, "
                         f"not {v.kernel}'s")
    dev = _check(v, g, args, None)
    if dev.type == "cpu":
        return traffic_sum_plain(v, g, args["x"])
    with torch.cuda.device(dev):
        sink = torch.zeros(g.cells * RED_THREADS, dtype=torch.int32,
                           device=dev)
        _prepare(v, g, args, None, dev, sink)[1]()
        return int(sink.to(torch.int64).sum()) % 2**32


def run(v: Variant, g: Grid, args: dict, out=None,
        device=None) -> torch.Tensor:
    """The variant on make_inputs' arguments: CPU tensors take the plain
    version, CUDA tensors the kernel (`out`, if given, receives the
    result). A store has no tensor argument but its seed: `device` says
    where it runs (default the seed's, else the card: with no card it
    raises, and device="cpu" runs the plain version)."""
    dev = _check(v, g, args, out)
    if dev is None:
        dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cpu":
        ref = plain(v, g, args, dev)
        return ref if out is None else out.copy_(ref)
    with torch.cuda.device(dev):
        out, launch = prepare(v, g, args, out, dev)
        launch()
    return out


# ---------------------------------------------------------------------------
# holding and timing
# ---------------------------------------------------------------------------

def compare(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, share of outputs that differ, bit-equal): every
    variant is held bit for bit (SUM_VARIANTS on exact inputs)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return math.inf, 1.0, False
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    share = (diff > 0).float().mean().item() if diff.numel() else 0.0
    itype = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        got.element_size()]
    return err, share, torch.equal(got.view(itype), ref.view(itype))


def library_is_the_map(v: Variant) -> bool:
    """Whether library(v) computes the variant's own function: a map that
    copies (or broadcasts lane 0 of) one block with no repeat, whose
    contiguous() of the view is its output byte for byte."""
    return (v.kernel == "fetch_map" and v.op in ("copy", "lane0")
            and len(v.ins) == 1 and v.rep == 1)


def library(v: Variant, g: Grid, args: dict, device):
    """One PyTorch call for the same data movement, as a yardstick: fill_
    of the output for a store; contiguous() of the view of the first
    block's pixels and lanes that the output names, in the output's order
    (lane 0 in every lane where the map broadcasts it or the input is a
    plane), for a map: the map's own function, byte for byte, where it
    copies one block with no repeat (library_is_the_map); amax of the
    corners (the first block's) or the sum of lane 0 (the second block's)
    for a reduction; for l1_mm the bf16 matmul of
    the blocks with the weight's lanes 0-3, whose product is the one the
    output holds (lane-inner, where the probe writes it planar)."""
    o = out_spec(v.out, g)
    if v.kernel == "store":
        buf = torch.empty(o.shape(g), dtype=_DTYPES[o.dtype], device=device)
        val = _store_value(v, args.get("seed"), o.dtype)
        return lambda: buf.fill_(val)
    x, b0 = args["x"], block(v.ins[0], v.array, g)
    if v.kernel == "fetch_map":
        a = cells(x, b0, g)[..., :o.xg // v.rep, :o.lg]
        if v.op == "lane0" or b0.lanes == 1:   # lane 0 in every lane
            a = a[..., 0:1].expand(*a.shape[:-1], o.lg)
        view = a.permute(0, 1, 3, 2, 4, 5) if o.form == "lanes" else (
            a.permute(0, 1, 3, 2, 5, 4))
        return view.contiguous
    if v.kernel == "l1_mm":
        a, w = cells(x, b0, g), args["w"]
        return lambda: torch.matmul(a, w[:, :4])
    if v.op == "corner_max":
        a = cells(x, b0, g)[..., 0:8, 0:8, :]
        return lambda: torch.amax(a, dim=(-3, -2, -1))
    a = cells(x, block(v.ins[1], v.array, g), g)[..., 0]
    return lambda: torch.sum(a, dim=(-2, -1), dtype=torch.float32)


def measure(v: Variant, g: Grid, dev: torch.device, iters: int = 100,
            seed: int = 0) -> dict:
    """Hold the variant against its plain version and time it. On a card:
    the kernel and the library call over `iters` back-to-back launches that
    cycle through copies of the arguments and outputs of ROTATE_BYTES in
    all (so that no launch finds its bytes in the 50 MB L2), captured in a
    CUDA graph and timed over one replay ("ms", "library_ms"); the same
    kernel launches issued one by one from Python ("eager_ms", which adds
    the host's cost of a launch where that exceeds the kernel's); the plain
    version over 2. On the CPU the wrapper is its plain version: the kernel
    times are None and the other times are the host's."""
    args = make_inputs(v, g, seed, dev)
    got = run(v, g, args, device=dev)
    ref = plain(v, g, args, dev)
    err, share, ok = compare(got, ref)
    del ref
    nbytes, ops = traffic_bytes(v, g), flops(v, g)
    distinct = distinct_bytes(v, g)
    t_bytes = distinct / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    row = {"name": v.name, "label": v.label, "site": v.site,
           "kernel": v.kernel, "bytes": nbytes, "distinct_bytes": distinct,
           "flops": ops,
           "max_abs_err": err, "share_differ": share, "equal_ok": ok,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           # l1_mm's products as FFMA, for comparison (the kernel does
           # them on the tensor cores)
           "ffma_floor_ms": ops / PEAK_F32_FLOPS * 1e3 if ops else None}
    if dev.type == "cuda":
        sets = [args] + [{k: t.clone() for k, t in args.items()}
                         for _ in range(min(16, math.ceil(
                             ROTATE_BYTES / distinct)) - 1)]
        n = len(sets)
        with torch.cuda.device(dev):
            launches = [prepare(v, g, s, got if k == 0 else None, dev)[1]
                        for k, s in enumerate(sets)]
            row["ms"] = time_ms(lambda k: launches[k % n](), dev, iters,
                                graph=True)
            row["eager_ms"] = time_ms(lambda k: launches[k % n](), dev,
                                      iters)
            libs = [library(v, g, s, dev) for s in sets]
            row["library_ms"] = time_ms(lambda k: libs[k % n](), dev, iters,
                                        graph=True)
        del sets, launches, libs
        # the distinct bytes' rate: over the memory's, a fetch was dropped
        row["rate_gbs"] = distinct / row["ms"] / 1e6
        row["spec_gbs"] = nbytes / row["ms"] / 1e6
        row["rate_ok"] = row["rate_gbs"] * 1e9 <= PEAK_BYTES
    else:
        row["ms"], row["eager_ms"], row["rate_gbs"] = None, None, None
        row["spec_gbs"], row["rate_ok"] = None, True
        row["library_ms"] = time_ms(
            lambda k: library(v, g, args, dev)(), dev, 1)
    row["plain_ms"] = time_ms(lambda k: plain(v, g, args, dev), dev, 2)
    row["ok"] = row["equal_ok"] and row["rate_ok"]
    return row


def format_row(r: dict) -> str:
    """One printed line of measure()'s row."""
    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"
    rate = ("" if r["rate_gbs"] is None else
            f" = {r['rate_gbs']:.0f} GB/s of distinct bytes "
            f"({100 * r['rate_gbs'] * 1e9 / PEAK_BYTES:.1f}% of 3.35 TB/s; "
            f"{r['spec_gbs']:.0f} GB/s by BlockSpecs)")
    ffma = ("" if r["ffma_floor_ms"] is None else
            f" (the products as FFMA: {r['ffma_floor_ms']:.4f} ms)")
    return (f"{r['name']:11s} ({r['site']}, {r['kernel']}): "
            f"{r['bytes'] / 1e6:.1f} MB by BlockSpecs, "
            f"{r['distinct_bytes'] / 1e6:.1f} MB distinct, kernel "
            f"{ms(r['ms'])} in a graph{rate}, {ms(r['eager_ms'])} launched "
            f"one by one, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}{ffma}, plain {ms(r['plain_ms'])}, library "
            f"{ms(r['library_ms'])}; max |kernel - plain| "
            f"{r['max_abs_err']:.3g} ({100 * r['share_differ']:.4f}% differ, "
            f"bar bit-equal){'' if r['ok'] else '  FAILED'}")


def add_args(ap, batch: int) -> None:
    """The tools' common arguments."""
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--size", type=int, default=512,
                    help="rows and columns of the output grid (ny * tr)")
    ap.add_argument("--tile", type=int, nargs=2, default=(64, 128),
                    metavar=("TR", "TC"))
    ap.add_argument("--iters", type=int, default=100,
                    help="timed launches of each kernel and library call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")


def grid_from_args(args, ap) -> Grid:
    tr, tc = args.tile
    if (args.batch < 1 or args.size % tr or args.size % tc or tr % 8
            or tc % 16 or args.size < max(tr, tc)):
        ap.error("--size must be a multiple of both tile sides, TR of 8 "
                 "and TC of 16")
    return Grid(args.batch, args.size // tr, args.size // tc, tr, tc)


def run_variants(names, g: Grid, dev: torch.device, iters: int, seed: int,
                 rows: "list | None" = None) -> bool:
    """measure() and print each named variant; append the rows to `rows`
    if given. True if every variant held its bar (and on a card stayed
    under the memory rate)."""
    ok = True
    for name in names:
        r = measure(VARIANTS[name], g, dev, iters, seed)
        print(format_row(r), flush=True)
        if rows is not None:
            rows.append(r)
        ok = ok and r["ok"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# tools/tmm_probe.py:79 (cch) and :122 (cpos): the four-tap 128 -> 128 layer
# ---------------------------------------------------------------------------

TMM_LAYOUTS = ("chlane", "poslane")
TMM_SITES = {"chlane": "tools/tmm_probe.py:79",
             "poslane": "tools/tmm_probe.py:122"}
TMM_TAPS, TMM_CH = 4, 128


def tmm_input_shape(layout: str, batch: int, ny: int, nx: int, tr: int = 64,
                    tc: int = 128) -> tuple:
    """The JAX tool's input array for its (batch, ny, nx) grid of (tr, tc)
    cells: (ny+1) tr rows and (nx+1) tc columns (at least the cells' blocks,
    ny (tr+8) x nx (tc+16), where the tile is small), channels last (chlane)
    or before the columns (poslane)."""
    rows = max((ny + 1) * tr, ny * (tr + 8))
    cols = max((nx + 1) * tc, nx * (tc + 16))
    if layout == "chlane":
        return (batch, rows, cols, TMM_CH)
    return (batch, rows, TMM_CH, cols)


def _tmm_check(x: torch.Tensor, w: torch.Tensor, layout: str,
               tile) -> tuple:
    """tap_mm's arguments -> (ny, nx): as many disjoint (tr+8, tc+16) blocks
    as the input holds each way."""
    if layout not in TMM_LAYOUTS:
        raise ValueError(f"layout must be one of {TMM_LAYOUTS}, got "
                         f"{layout!r}")
    tr, tc = tile
    if int(tr) != tr or int(tc) != tc or tr < 1 or tc < 1:
        raise ValueError(f"tile must be two positive ints, got {tile}")
    ch_dim = 3 if layout == "chlane" else 2
    if x.dim() != 4 or x.shape[ch_dim] != TMM_CH:
        raise ValueError(f"{layout}: x must be 4-d with {TMM_CH} channels in "
                         f"dim {ch_dim}, got {tuple(x.shape)}")
    if tuple(w.shape) != (TMM_TAPS, TMM_CH, TMM_CH):
        raise ValueError(f"w must be [{TMM_TAPS}, {TMM_CH}, {TMM_CH}], got "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous bfloat16, got "
                            f"{t.dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    rows, cols = x.shape[1], x.shape[5 - ch_dim]
    ny, nx = rows // (tr + 8), cols // (tc + 16)
    if ny < 1 or nx < 1:
        raise ValueError(f"x of {rows} x {cols} positions holds no "
                         f"({tr + 8}, {tc + 16}) block")
    return ny, nx


def _tmm_cells(xc: torch.Tensor, n0: int, nb: int, ny: int, nx: int, tr: int,
               tc: int) -> torch.Tensor:
    """The cells' input blocks as one view [nb, ny, nx, tr+8, tc+16, 128] of
    a [B, R, C, 128] view xc (any strides), from image n0."""
    sn, sr, sc, sch = xc.stride()
    return xc.as_strided((nb, ny, nx, tr + 8, tc + 16, TMM_CH),
                         (sn, (tr + 8) * sr, (tc + 16) * sc, sr, sc, sch),
                         xc.storage_offset() + n0 * sn)


def tap_mm_plain(x: torch.Tensor, w: torch.Tensor, layout: str,
                 tile=(64, 128), chunk: int = 4) -> torch.Tensor:
    """Plain PyTorch version of tap_mm: four shifted products of each cell's
    block with w[t], summed in f32 (TF32 off) in tap order, rounded to bf16
    once; `chunk` images at a time."""
    ny, nx = _tmm_check(x, w, layout, tile)
    tr, tc = tile
    xc = x if layout == "chlane" else x.permute(0, 1, 3, 2)
    b, wf = x.shape[0], w.float()
    out = torch.empty((b, ny * tr, nx * tc, TMM_CH), dtype=torch.bfloat16,
                      device=x.device)
    with no_tf32():
        for n0 in range(0, b, chunk):
            nb = min(chunk, b - n0)
            blocks = _tmm_cells(xc, n0, nb, ny, nx, tr, tc)
            acc = None
            for t in range(TMM_TAPS):
                term = blocks[:, :, :, t:t + tr, t:t + tc].float() @ wf[t]
                acc = term if acc is None else acc.add_(term)
            out[n0:n0 + nb] = (acc.to(torch.bfloat16).permute(0, 1, 3, 2, 4, 5)
                               .reshape(nb, ny * tr, nx * tc, TMM_CH))
    return out if layout == "chlane" else out.permute(0, 1, 3, 2).contiguous()


TMM_SMS = 132        # an H100's SMs: tmm_walk's default grid


def pack_tap_mm(w: torch.Tensor) -> torch.Tensor:
    """w [4, 128 in, 128 out] -> [2, 32, 128, 8], csrc/tmm.cu's register
    order: the weights are wgmma's A operand W^T [co, k] (k = 128 t + ci),
    warpgroup h holding output channels 64h .. 64h + 63, k16 step s
    covering k = 16s .. 16s + 15, and thread (warp v, lane 4g + c) of the
    warpgroup loading its 16 bytes [h, s, 32v + 4g + c] as four registers of
    two bf16 (lower k first): register r holds channel 64h + 16v + g +
    8 (r % 2), k = 16s + 8 (r // 2) + 2c + {0, 1} (mma.m16n8k16's A
    fragment, each warp 16 rows)."""
    # w[t, ci, co] with ci = 16 kk + 8 rh + 2 c + e, co = 64 h + 16 v + 8 rl
    # + g, as (h, t, kk, v, g, c, rh, rl, e); s = 8 t + kk, r = 2 rh + rl
    return (w.reshape(TMM_TAPS, 8, 2, 4, 2, 2, 4, 2, 8)
            .permute(5, 0, 1, 6, 8, 3, 2, 7, 4)
            .reshape(2, TMM_TAPS * 8, 128, 8).contiguous())


def tmm_walk(b: int, ny: int, nx: int, tr: int, tc: int,
             blocks: int = TMM_SMS) -> list:
    """csrc/tmm.cu's walk: the rows of work (128 positions of one cell row,
    segment by segment: u = (((n ny + i) nx + j) nseg + seg) tr + o) cut
    evenly over min(rows, blocks) blocks -> for each block its work units,
    (segment, first row oa, end row ob) runs of consecutive rows of one
    segment. A unit loads its cell rows oa .. ob + 2 once (ob - oa + 3
    loads, into a ring of 5 slots; poslane's transposed there from a
    staging slot)."""
    nseg = tc // 128
    total = b * ny * nx * nseg * tr
    grid = min(total, blocks)
    per, extra = divmod(total, grid)
    units = []
    for bid in range(grid):
        u0 = bid * per + min(bid, extra)
        u1 = u0 + per + (bid < extra)
        mine = []
        while u0 < u1:
            oa = u0 % tr
            ob = min(tr, oa + u1 - u0)
            mine.append((u0 // tr, oa, ob))
            u0 += ob - oa
        units.append(mine)
    return units


def prepare_tap_mm(x: torch.Tensor, w: torch.Tensor, layout: str,
                   tile=(64, 128)):
    """Check the arguments and pack the weights once -> (out, launch) for a
    CUDA run; launch() enqueues the kernel on the current stream and counts
    it in LAUNCHES["tap_mm"]. The kernel takes tc a multiple of 128 and
    columns a multiple of 8 (any tr)."""
    ny, nx = _tmm_check(x, w, layout, tile)
    tr, tc = tile
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    rows, cols = x.shape[1], x.shape[3 if layout == "poslane" else 2]
    if tc % 128 or cols % 8:
        raise ValueError(f"the kernel takes tc a multiple of 128 and columns "
                         f"a multiple of 8, got tile {tile}, {cols} columns")
    b = x.shape[0]
    shape = ((b, ny * tr, nx * tc, TMM_CH) if layout == "chlane"
             else (b, ny * tr, TMM_CH, nx * tc))
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    wp = pack_tap_mm(w)
    lib = _lib("tmm")
    code = TMM_LAYOUTS.index(layout)

    def launch(_keep=(x, wp, out)) -> None:   # the tensors outlive launch
        err = lib.w2x_tap_mm(code, x.data_ptr(), wp.data_ptr(),
                             out.data_ptr(), b, rows, cols, ny, nx, tr, tc,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            msg = lib.w2x_error_string(err).decode()
            raise RuntimeError(f"tap_mm kernel, {layout}: {msg}")
        LAUNCHES["tap_mm"] += 1

    return out, launch


def tap_mm(x: torch.Tensor, w: torch.Tensor, layout: str,
           tile=(64, 128)) -> torch.Tensor:
    """The four-tap 128 -> 128 layer of tools/tmm_probe.py on the grid of
    (tr, tc) cells that the input holds, each reading its disjoint
    (tr+8, tc+16) block (the JAX BlockSpecs):
        out[n, i tr + y, j tc + x, co] = sum over t = 0..3 and ci of
            in[n, i(tr+8) + y + t, j(tc+16) + x + t, ci] * w[t, ci, co]
    with f32 sums rounded once to bf16. layout "chlane": x [B, R, C, 128] ->
    [B, ny tr, nx tc, 128]; "poslane": x [B, R, 128, C] -> [B, ny tr, 128,
    nx tc]. x and w [4, 128, 128] contiguous bf16. CPU tensors take the plain
    version; CUDA tensors take the kernel (csrc/tmm.cu), or raise."""
    _tmm_check(x, w, layout, tile)
    if x.device.type == "cpu":
        return tap_mm_plain(x, w, layout, tile)
    with torch.cuda.device(x.device):
        out, launch = prepare_tap_mm(x, w, layout, tile)
        launch()
    return out


def tap_mm_bound(batch: int, ny: int, nx: int, tr: int, tc: int) -> dict:
    """The bytes (the (tr+3, tc+3) positions of each cell's block that the
    four taps read, once; the output written once; the weights once), the
    operations and the least time of the layer on the card, the larger of
    the two. The rest of a (tr+8, tc+16) block is never read."""
    nbytes = 2 * (batch * ny * nx * ((tr + 3) * (tc + 3) + tr * tc) * TMM_CH
                  + TMM_TAPS * TMM_CH * TMM_CH)
    ops = 2 * TMM_TAPS * TMM_CH * TMM_CH * batch * ny * nx * tr * tc
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def tmm_inputs(shape: tuple, seed: int, device) -> tuple:
    """(x, w) drawn as k / 16, k = 0..15: every product is a multiple of
    1/256 and a 512-term sum stays under 2^24 such units, so it is exact in
    f32 in any order and the kernel equals the plain version bit for bit."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 16, shape, generator=gen, device=dev)
    w = torch.randint(0, 16, (TMM_TAPS, TMM_CH, TMM_CH), generator=gen,
                      device=dev)
    return ((x.to(torch.bfloat16) / 16).contiguous(),
            (w.to(torch.bfloat16) / 16).contiguous())


def tap_mm_library(x: torch.Tensor, w: torch.Tensor, layout: str,
                   tile=(64, 128)) -> dict:
    """Two PyTorch yardsticks for the same layer, as callables: "matmul",
    the sum of four bf16 torch.matmul over the shifted views of the blocks
    (the views copied first); "conv", one cuDNN bf16 conv2d over the whole
    input with a 4 x 4 kernel whose 12 off-diagonal taps are zero: 4x the
    products, over every position of the plane (chlane: the input viewed
    channels_last, no copy; poslane: the [B, R, 128, C] array viewed as
    NCHW, which PyTorch copies to a standard layout first)."""
    ny, nx = _tmm_check(x, w, layout, tile)
    tr, tc = tile
    if layout == "chlane":
        v = _tmm_cells(x, 0, x.shape[0], ny, nx, tr, tc)
        views = [v[:, :, :, t:t + tr, t:t + tc] for t in range(TMM_TAPS)]
        mats = list(w)
        xin = x.permute(0, 3, 1, 2)
    else:
        sn, sr, sch, sc = x.stride()
        v = x.as_strided((x.shape[0], ny, nx, tr + 8, TMM_CH, tc + 16),
                         (sn, (tr + 8) * sr, (tc + 16) * sc, sr, sch, sc))
        views = [v[:, :, :, t:t + tr, :, t:t + tc] for t in range(TMM_TAPS)]
        mats = [wt.t() for wt in w]
        xin = x.permute(0, 2, 1, 3)
    k = torch.zeros((TMM_CH, TMM_CH, TMM_TAPS, TMM_TAPS),
                    dtype=torch.bfloat16, device=x.device)
    for t in range(TMM_TAPS):
        k[:, :, t, t] = w[t].t()
    k = k.contiguous(memory_format=torch.channels_last)

    def matmul():
        acc = None
        for vt, m in zip(views, mats):
            term = vt @ m if layout == "chlane" else m @ vt
            acc = term if acc is None else acc + term
        return acc

    return {"matmul": matmul, "conv": lambda: F.conv2d(xin, k)}


def measure_tap_mm(layout: str, batch: int, ny: int, nx: int, tr: int,
                   tc: int, dev: torch.device, iters: int = 20,
                   seed: int = 0) -> dict:
    """Hold tap_mm against its plain version (bit for bit on tmm_inputs)
    at the JAX tool's input shape and time it: on a card the kernel's
    launches (CUDA events around `iters` back to back), the plain version
    once and the two library yardsticks; on the CPU the plain version only,
    on the host's clock."""
    x, w = tmm_inputs(tmm_input_shape(layout, batch, ny, nx, tr, tc), seed,
                      dev)
    got = tap_mm(x, w, layout, (tr, tc))
    ref = tap_mm_plain(x, w, layout, (tr, tc))
    err, share, ok = compare(got, ref)
    del ref
    row = {"name": layout, "site": TMM_SITES[layout], "kernel": "tap_mm",
           "shape": tuple(x.shape), "max_abs_err": err,
           "share_differ": share, "ok": ok,
           **tap_mm_bound(batch, ny, nx, tr, tc)}
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            _, launch = prepare_tap_mm(x, w, layout, (tr, tc))
            row["ms"] = time_ms(lambda k: launch(), dev, iters)
            lib = tap_mm_library(x, w, layout, (tr, tc))
            row["library_ms"] = time_ms(lambda k: lib["matmul"](), dev,
                                        max(2, iters // 4))
            row["conv_ms"] = time_ms(lambda k: lib["conv"](), dev,
                                     max(2, iters // 4))
            del lib
        row["rate_gbs"] = row["bytes"] / row["ms"] / 1e6
        row["tflops"] = row["flops"] / row["ms"] / 1e9
    else:
        row.update(ms=None, library_ms=None, conv_ms=None, rate_gbs=None,
                   tflops=None)
    row["plain_ms"] = time_ms(
        lambda k: tap_mm_plain(x, w, layout, (tr, tc)), dev, 1)
    return row


def format_tap_mm_row(r: dict) -> str:
    """One printed line of measure_tap_mm's row."""
    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"
    rate = ("" if r["ms"] is None else
            f" = {r['rate_gbs']:.0f} GB/s ({100 * r['bound_ms'] / r['ms']:.1f}"
            f"% of the bound), {r['tflops']:.1f} TFLOP/s")
    return (f"{r['name']:8s} ({r['site']}, tap_mm) x {r['shape']}: "
            f"{r['bytes'] / 1e9:.3f} GB, {r['flops'] / 1e12:.4f} TFLOP; "
            f"kernel {ms(r['ms'])}{rate}; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} (bytes {r['bytes_ms']:.4f} ms, operations "
            f"{r['ops_ms']:.4f} ms); plain {ms(r['plain_ms'])}; library: 4 "
            f"bf16 matmul {ms(r['library_ms'])}, cuDNN 4x4 conv with zero "
            f"off-diagonal taps {ms(r['conv_ms'])}; max |kernel - plain| "
            f"{r['max_abs_err']:.3g} ({100 * r['share_differ']:.4f}% differ, "
            f"bar bit-equal){'' if r['ok'] else '  FAILED'}")


# ---------------------------------------------------------------------------
# tools/accpp_probe.py:127, shift_cost_probe.py:156, l4_shift_probe.py:130:
# the stack with two accumulators or with its shifts forced to zero
# ---------------------------------------------------------------------------

VARIANT_SITES = {"accpp": "tools/accpp_probe.py:127",
                 "shift_cost": "tools/shift_cost_probe.py:156",
                 "l4_shift": "tools/l4_shift_probe.py:130"}
# (fx, fy) of each shift_cost mode (tools/shift_cost_probe.py:188): a factor
# 0 forces that axis' cell offsets Dx or Dy of layers 2-7 to 0
SHIFT_MODES = {"base": (1, 1), "noshiftx": (0, 1), "noshifty": (1, 0),
               "noshift": (0, 0)}
# each l4_shift mode (tools/l4_shift_probe.py:40-117) -> (layers run, layer
# 4's zero-shift mask, the layer whose whole plane is returned). preshift,
# stage and stagep are Mosaic schedules of l4's function (a pre-shifted VPU
# copy, layer 4 staged in VMEM before its store) and scratch computes layer 4
# into a scratch and writes layer 3: on Hopper a shift is a descriptor offset
# and the epilogue already stages its tile in shared memory, so they run
# l4's kernels.
L4_MODES = {"base": (3, 0, 3), "l4": (4, 0, 4), "zshift": (4, 3, 4),
            "zdx": (4, 1, 4), "preshift": (4, 0, 4), "stage": (4, 0, 4),
            "stagep": (4, 0, 4), "scratch": (4, 0, 3)}
L4_SAME_AS_L4 = ("preshift", "stage", "stagep", "scratch")


def shift_zs(fx: int, fy: int) -> int:
    """The zero-shift mask of factors (fx, fy): bit 0 where fx = 0 (column
    offsets), bit 1 where fy = 0 (row offsets)."""
    if fx not in (0, 1) or fy not in (0, 1):
        raise ValueError(f"fx and fy are 0 or 1, got {(fx, fy)}")
    return (1 - fx) | 2 * (1 - fy)


def _variant_layers_plain(ylow: torch.Tensor, sp, upto: int,
                          zs: tuple) -> list:
    """Plain layers 1..upto (7: the whole stack) of the scale stack, each
    layer k + 1 under zero-shift mask zs[k] -> every layer's stored output:
    the NHWC planes of layers 1-6 and layer 7's Y_s2d [N, hl, wl, 4] (the
    fold's), in ylow's dtype."""
    outs = [stack.l1_plain(ylow, sp)]
    for k in range(1, min(upto, 6)):
        outs.append(stack.mma_layer_plain(outs[-1], sp.wm[k - 1], sp[k][1],
                                          zs[k]))
    if upto == 7:
        outs.append(stack.last_layer(outs[-1], sp, zs[6]))
    return outs


def _variant_layers(ylow: torch.Tensor, sp, upto: int, zs: tuple,
                    pp: bool = False) -> list:
    """The same on the card: one launch a layer (stack._Launcher, counted
    under KERNEL_LAUNCHES["probe"]), layers 2-6 under zs[k] or with two
    accumulators (pp) on csrc/mma.cu's variants, layer 7 folded under
    zs[6]."""
    n, hl, wl = ylow.shape
    outs, src = [], ylow
    with torch.cuda.device(ylow.device):
        run = stack._Launcher("probe", ylow, None)
        for k in range(min(upto, 6)):
            dst = torch.empty((n, 2 * hl + 12 - 2 * k, 2 * wl + 12 - 2 * k,
                               stack.WIDTHS[k][1]), dtype=ylow.dtype,
                              device=ylow.device)
            run.layer(k, False, src, sp, dst, n, hl, wl, zs=zs[k],
                      pp=pp and k > 0)
            outs.append(dst)
            src = dst
        if upto == 7:
            out = torch.empty((n, hl, wl, 4), dtype=ylow.dtype,
                              device=ylow.device)
            run.layer(6, False, src, sp, out, n, hl, wl, zs=zs[6])
            outs.append(out)
    return outs


def _check_variant(ylow: torch.Tensor, sp) -> None:
    stack._check(ylow, sp)
    if getattr(sp, "wm", None) is None:
        raise ValueError("the probes' stacks need prep_params' packed "
                         "weights (StackParams.wm)")


def _variant(ylow: torch.Tensor, sp, upto: int, zs: tuple,
             pp: bool = False) -> list:
    _check_variant(ylow, sp)
    if ylow.device.type == "cpu":
        return _variant_layers_plain(ylow, sp, upto, zs)
    return _variant_layers(ylow, sp, upto, zs, pp)


_NO_ZS = (0,) * 7


def stack_scale_pp_plain(ylow: torch.Tensor, sp) -> torch.Tensor:
    """Plain version of stack_scale_pp: stack_scale's plain version with
    layers 2-6 from the packed weights (stack_scale_plain(mma=True)), the
    function of the one-accumulator tensor-core layers."""
    _check_variant(ylow, sp)
    return stack.stack_scale_plain(ylow, sp, mma=True)


def stack_scale_pp(ylow: torch.Tensor, sp) -> torch.Tensor:
    """tools/accpp_probe.py's "pp": ylow [N, hl, wl] bf16 -> Y_s2d
    [N, hl, wl, 4], stack_scale's function with each of layers 2-6 keeping
    its outputs in two register accumulators (csrc/mma.cu PP), equal to
    stack_scale's tensor-core layers bit for bit; 7 launches. CPU tensors
    take the plain version; CUDA tensors take the kernels."""
    if ylow.device.type == "cpu":
        return stack_scale_pp_plain(ylow, sp)
    return _variant(ylow, sp, 7, _NO_ZS, pp=True)[-1]


def shift_stack_plain(ylow: torch.Tensor, sp, fx: int, fy: int):
    """Plain version of shift_stack."""
    zs = shift_zs(fx, fy)
    _check_variant(ylow, sp)
    return _variant_layers_plain(ylow, sp, 7, (0,) + (zs,) * 6)[-1]


def shift_stack(ylow: torch.Tensor, sp, fx: int, fy: int) -> torch.Tensor:
    """tools/shift_cost_probe.py's stack: ylow [N, hl, wl] -> [N, hl, wl, 4]
    in s2d layout, layer 1 as in stack_scale, layers 2-7 under zero-shift
    mask shift_zs(fx, fy): on a zeroed axis tap k of position p reads
    (p & ~1) | ((p + k) & 1), its own s2d cell, where stack_scale reads
    p + k (wrong by design; fx = fy = 1 is stack_scale's function). 7
    launches. CPU tensors take the plain version; CUDA tensors take the
    kernels (bf16 where a mask is set: the variants are tensor-core layers).
    Layer 7 runs folded in every mode (csrc/l7.cu, the JAX tool's
    structure: its shift-sum reads the cell Dy*fy, Dx*fx), so base is
    stack_scale's kernels, bit for bit on the card, and the modes differ
    in the masks alone."""
    zs = shift_zs(fx, fy)
    return _variant(ylow, sp, 7, (0,) + (zs,) * 6)[-1]


def _l4_zs(mode: str) -> tuple:
    if mode not in L4_MODES:
        raise ValueError(f"mode must be one of {list(L4_MODES)}, got "
                         f"{mode!r}")
    upto, zs4, keep = L4_MODES[mode]
    return upto, (0, 0, 0, zs4, 0, 0, 0), keep


def l4_shift_plain(ylow: torch.Tensor, sp, mode: str) -> torch.Tensor:
    """Plain version of l4_shift."""
    upto, zs, keep = _l4_zs(mode)
    _check_variant(ylow, sp)
    return _variant_layers_plain(ylow, sp, upto, zs)[keep - 1]


def l4_shift(ylow: torch.Tensor, sp, mode: str) -> torch.Tensor:
    """tools/l4_shift_probe.py's body: layers 1-3 of the scale stack, then
    layer 4 by mode (L4_MODES): "l4" as in production, "zshift" with all its
    shifts zeroed (zero-shift mask 3), "zdx" its column shifts (mask 1);
    "base" stops after layer 3. Returns the whole NHWC plane of layer 4
    (base and scratch: of layer 3), halo and all, as stack_scale_upto(...,
    out="whole") gives it: [N, 2hl+6, 2wl+6, 64] ([N, 2hl+8, 2wl+8, 64]).
    3 or 4 launches. CPU tensors take the plain version; CUDA tensors take
    the kernels."""
    upto, zs, keep = _l4_zs(mode)
    return _variant(ylow, sp, upto, zs)[keep - 1]


def variant_plans(zs: int = 0, pp: bool = False, layers=range(2, 7)) -> str:
    """The chunk plan of each tensor-core layer as a variant runs it, for
    the tools to print: "L<k> kc x stages (smem bytes)"."""
    plans = []
    for k in layers:
        plan = stack.mma_plan(*stack.WIDTHS[k - 1], zs, pp)
        plans.append(f"L{k} {plan.kc} x {plan.stages} ({plan.smem_bytes} B)")
    return ", ".join(plans)


def ptxas_serialized() -> "list | None":
    """ptxas' warnings that it serialized wgmma instructions in
    csrc/mma.cu, from the build this process ran; None where the library
    was built by another process (its output was not seen here)."""
    log = _build.BUILD_LOG.get("mma")
    if log is None:
        return None
    return [ln.strip() for ln in log[1].splitlines() if "serializ" in ln]
