"""The model's operations done in the window over the window's length at
the chip's peak: each call's own count (`flops()`; a vgg_7 stack call
2 x 287,136 FLOP for each pixel of its output plane, the noise stack at
the input's size, the scale stack at the output's), a bf16 call at
989 TFLOP/s, an f32 call at the TF32 rate, 495 TFLOP/s (the highest rate
of any f32 path on the chip)."""

from benchmark import counts


def read(run):
    peak_s = sum(k * c.flops() / counts.PEAK_FLOPS[c.dtype]
                 for c, k in run.calls.items())
    return 100.0 * peak_s / run.window_s
