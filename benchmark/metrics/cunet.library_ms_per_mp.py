"""Device milliseconds per output megapixel of every kernel in the trace
that is not one of the program's hand-written kernels (the __global__
functions of waifu2x_torch/csrc), copies and sets left out: UpCUNet's cuDNN
convolutions, its SE reductions and scales, crops and skip adds, the
tiling's pads and copies, the u8 map. What later hand kernels would take
over."""

COPIES = ("Memcpy", "Memset")


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    from benchmark.trace import base_name
    t = run.trace.seconds(lambda n: base_name(n) not in run.kernels
                          and not n.startswith(COPIES))
    return 1e3 * t / (run.out_px / 1e6)
