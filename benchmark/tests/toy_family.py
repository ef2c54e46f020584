"""The program's side of the toy architecture of `toy_reference.py`, for the
harness's tests: the same two layers and pixel shuffle, run in the type the
configuration states for its one stack (role "sr"), with weights and
activations stored in it, in plain PyTorch (the port has no such model).
Its calls count their own operations."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

STRIP_ROWS = 2                      # output rows of one input row
MAC_PER_IN_PX = 9 * (3 * 8 + 8 * 12)


@dataclasses.dataclass(frozen=True)
class ToyCall:
    dtype: str
    n: int
    h: int
    w: int

    def flops(self) -> int:
        return 2 * MAC_PER_IN_PX * self.n * self.h * self.w


class Program:
    def __init__(self, cfg: dict, weights: dict, device):
        (stack,) = cfg["stacks"]
        self.dtype = stack["dtype"]
        self.device = torch.device(device)
        dt = getattr(torch, self.dtype)
        self.layers = [(w.to(device, dt), b.to(device, dt))
                       for w, b in weights["sr"]]

    def prepare(self, x):
        """u8 [n, h, w, 3] -> [n, 3, h, w] in [0, 1], in the stack's type."""
        return (x.permute(0, 3, 1, 2).to(torch.float32) / 255.0).to(
            self.layers[0][0].dtype)

    def step(self, x):
        (w1, b1), (w2, b2) = self.layers
        x = F.conv2d(F.pad(x, (2, 2, 2, 2), mode="replicate"), w1, b1)
        x = F.conv2d(F.leaky_relu(x, 0.1), w2, b2)
        x = torch.clamp(F.pixel_shuffle(x, 2).to(torch.float32), 0.0, 1.0)
        out = torch.round(x * 255.0).to(torch.uint8)
        return out.permute(0, 2, 3, 1).contiguous(), None

    def calls(self, batch) -> list:
        return [ToyCall(self.dtype, batch.n, batch.h, batch.w)]

    def out_px(self, batch) -> int:
        return 4 * batch.n * batch.h * batch.w

    def out_shape(self, batch) -> tuple:
        return batch.n, 2 * batch.h, 2 * batch.w, 3

    def frames(self, out):
        return out


def build(cfg: dict, weights: dict, device) -> Program:
    return Program(cfg, weights, device)
