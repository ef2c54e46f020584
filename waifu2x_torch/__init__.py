"""waifu2x_torch — the PyTorch + CUDA port of waifu2x_tpu for NVIDIA Hopper.

It loads the same reference JSON weights and runs the same conversion
math as the JAX package, with the conv stack as a hand-written CUDA kernel
(ops/stack.py, csrc/stack.cu) and everything around it in plain PyTorch.
It imports neither JAX nor waifu2x_tpu.

Package layout:
  config.py  pipeline.py       Config; the noise and scale steps, Converter
  stream.py                    batched, ordered frame-stream runtime
  models/    srcnn.py          architecture spec, validation, SRCNN module
             weights.py        reference JSON weight format load/save
             zoo.py            built-in model management
  ops/       convstack.py      F.conv2d stack (f32 reference, TF32 off)
             stack.py          conv-stack kernel wrapper + plain version
             _build.py         nvcc build + ctypes load of csrc/*.cu
             color.py resize.py s2d.py   colour maps, resizes, layouts
  csrc/      stack.cu          the CUDA kernel (sm_90a)
  utils/                       logging, PSNR/throughput metrics
"""

__version__ = "0.1.0"

from waifu2x_torch.config import Config  # noqa: F401
from waifu2x_torch.ops.convstack import (  # noqa: F401
    conv_stack_valid,
    convert_plane,
    leaky_relu,
)
from waifu2x_torch.ops.color import bgr_to_yuv, yuv_to_bgr  # noqa: F401
from waifu2x_torch.ops.resize import resize  # noqa: F401
from waifu2x_torch.utils.metrics import psnr  # noqa: F401
from waifu2x_torch.utils.logging import get_logger  # noqa: F401
