"""Output megapixels of every dispatch of the window over the window's
length on the host's clock (first enqueue to the last dispatch's end)."""


def read(run):
    return run.out_px / 1e6 / run.window_s
