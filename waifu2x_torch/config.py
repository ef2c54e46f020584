"""Framework configuration — one dataclass replacing the reference's two
config mechanisms: the TCLAP flag set (main.cpp:26-61, C1) and the
modelUtility singleton carrying nJob + blockSplittingSize
(modelHandler.hpp:92-113, C10). Defaults match the reference exactly.

The port's own copy of the JAX package's Config: same fields, defaults and
validation, so one Config value means the same conversion in both
packages. `use_pallas` keeps its name for that reason; here it selects the
hand-written CUDA conv-stack kernel (ops/stack.py). Three fields are the
port's own: `arch` chooses the model ("vgg7", the reference's 7-layer
model, or "upcunet", waifu2x's UpCUNet, models/cunet.py), and an UpCUNet
takes its weights from `model_file` (the port's format, models/cunet.py:
save_params) or draws them from `model_seed`."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference CLI flags (main.cpp:26-61), identical defaults ---
    mode: str = "noise_scale"          # noise | scale | noise_scale
    noise_level: int = 1               # 1 | 2
    scale_ratio: float = 2.0
    model_dir: str = "models"
    jobs: int = 4                      # kept for CLI compat; host-side only

    # --- modelUtility singleton state (modelHandler.hpp:98-99) ---
    block_size: int = 512              # blockSplittingSize (square)

    # --- extensions (no reference analogue) ---
    precision: str = "highest"         # f32 conv precision; the port always
    #   runs its f32 path at full f32 (TF32 off), the "highest" setting
    compute_dtype: str = "auto"        # auto | float32 | bfloat16; auto =
    #   float32 on the non-kernel path, bfloat16 activations (f32
    #   accumulation) in the conv-stack kernel
    use_pallas: "bool | str" = "auto"  # conv-stack kernel: True | False |
    #   "auto". "auto" enables the kernel when the device is a CUDA card
    #   AND the model matches the flagship 7-layer architecture; anything
    #   else takes the non-kernel path. True forces the kernel path on any
    #   device (its plain PyTorch version on the CPU); an unsupported
    #   architecture still takes the non-kernel path.
    tile_size: int = 512               # device tile size for batched tiling
    batch_tiles: int = 8               # tiles batched per device step
    mesh: str = "auto"                 # multi-device mesh: "auto" | "off" |
    #   "DPxSP" | "DPxDYxSP" (parallel/mesh_pipeline.py; "auto" shards only
    #   on a host with two or more cards)
    arch: str = "vgg7"                 # vgg7 | upcunet: the model. An
    #   UpCUNet is one RGB 2x pass (mode scale or noise_scale, as its
    #   weights were trained; scale_ratio 2) over 436-pixel tiles, bf16 on
    #   the card under compute_dtype "auto", f32 on the CPU
    model_file: "str | None" = None    # UpCUNet weights (models/cunet.py)
    model_seed: "int | None" = None    # UpCUNet weights drawn from a seed
    alpha: str = "ignore"              # ignore (reference: IMREAD_COLOR
    #   drops alpha, main.cpp:74) | bicubic (resample alpha alongside,
    #   hints-jp.md:76-81) | flatten (composite onto white before
    #   processing, the original Lua loader: image_loader.lua:23-33)

    def __post_init__(self):
        if self.mode not in ("noise", "scale", "noise_scale"):
            raise ValueError(f"invalid mode: {self.mode!r}")
        if self.noise_level not in (1, 2):
            raise ValueError(f"invalid noise_level: {self.noise_level}")
        if self.jobs < 1:
            # mirrors modelUtility::setNumberOfJobs validation
            raise ValueError("jobs must be >= 1")
        if self.block_size < 0:
            # mirrors modelUtility::setBlockSize validation
            raise ValueError("block_size must be >= 0")
        if self.compute_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"invalid compute_dtype: {self.compute_dtype!r}")
        if self.use_pallas not in (True, False, "auto"):
            raise ValueError(f"invalid use_pallas: {self.use_pallas!r}")
        if self.alpha not in ("ignore", "bicubic", "flatten"):
            raise ValueError(f"invalid alpha: {self.alpha!r}")
        if self.arch not in ("vgg7", "upcunet"):
            raise ValueError(f"invalid arch: {self.arch!r}")
        if self.arch == "upcunet" and (self.mode == "noise"
                                       or self.scale_ratio != 2.0):
            raise ValueError("an UpCUNet is one 2x pass: mode scale or "
                             "noise_scale, scale_ratio 2")
        self.mesh_shape()   # validates the mesh spec

    def mesh_shape(self) -> "tuple[int, int, int] | str":
        """Parse the mesh spec: "auto"/"off" pass through; "AxB" means
        (dp=A, dy=1, sp=B); "AxBxC" means (dp, dy, sp)."""
        if self.mesh in ("auto", "off"):
            return self.mesh
        parts = self.mesh.split("x")
        if len(parts) not in (2, 3) or not all(p.isdigit() and int(p) > 0
                                               for p in parts):
            raise ValueError(
                f"invalid mesh: {self.mesh!r} (want 'auto', 'off', "
                f"'DPxSP' or 'DPxDYxSP')")
        dims = tuple(int(p) for p in parts)
        return (dims[0], 1, dims[1]) if len(dims) == 2 else dims

    def with_block_size_exp2_square(self, exp: int) -> "Config":
        """Power-of-two square block helper, mirroring
        modelUtility::setBlockSizeExp2Square (modelHandler.cpp:215-220).
        Config is frozen, so this returns a new instance."""
        if exp < 0:
            raise ValueError("exp must be >= 0")
        return dataclasses.replace(self, block_size=2 ** exp)
