"""Device milliseconds per output megapixel of every operation in the trace
that is not one of the program's hand-written kernels (the __global__
functions of waifu2x_torch/csrc): the colour map, the U/V phases, the
PyTorch u8 tail, band concatenation, casts, and the copies to and from
the host."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    from benchmark.trace import base_name
    other = run.trace.seconds(lambda n: base_name(n) not in run.kernels)
    return 1e3 * other / (run.out_px / 1e6)
