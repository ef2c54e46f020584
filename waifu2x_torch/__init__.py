"""waifu2x_torch — the PyTorch + CUDA port of waifu2x_tpu for NVIDIA Hopper.

It loads the same reference JSON weights and runs the same conversion
math, command line, streams, multi-device paths and training as the JAX
package, with every Pallas kernel of that package written by hand in CUDA
for sm_90a (csrc/, built with nvcc and loaded with ctypes) and everything
around them in plain PyTorch. It imports neither JAX nor waifu2x_tpu.

Package layout:
  config.py  pipeline.py       Config; the noise and scale steps, Converter
  stream.py                    batched, ordered frame-stream runtime
  cli.py io.py native.py       the waifu2x-torch command line; image I/O on
  pngcodec.py                  the shared native codecs, cv2, PIL or numpy
  models/    srcnn.py          architecture spec, validation, SRCNN module
             weights.py        reference JSON weight format load/save
             zoo.py            built-in model management
  ops/       convstack.py      F.conv2d stack (f32 reference, TF32 off)
             stack.py          the conv-stack kernels' wrappers + plain
                               versions (layers 1, 2-6, 6 as int8 or
                               Winograd, 7; the truncation)
             probe.py          the data-movement and layer probes
             _build.py         nvcc build + ctypes load of csrc/*.cu
             color.py resize.py s2d.py   colour maps, resizes, layouts,
                               weight packers
  csrc/      *.cu *.cuh        the CUDA kernels (sm_90a): l1.cu, mma.cu,
                               mma_tf32.cu, i8.cu, wino.cu, l7.cu,
                               gather.cu, epi.cu, probe.cu, tmm.cu
  parallel/  mesh.py           devices on named axes, sharded tensors, halos
             sharded.py fast_sharded.py mesh_pipeline.py   the mesh paths
             multihost.py      several processes (torch.distributed)
             tiles.py          the non-kernel path's block tiler
  train/     data.py           training pairs (pairwise_transform.lua)
             train.py          TrainConfig, the Adam steps (sharded too),
                               train_loop
             qat.py            the int8 layer-6 QAT loss and its twin stack
             checkpoint.py     checkpoints and the stream's frame cursor, in
                               the JAX package's formats
  tools/                       measurement and demo scripts (python -m
                               waifu2x_torch.tools.<name>), train_demo
  utils/                       logging, PSNR, timing, the build cache
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
