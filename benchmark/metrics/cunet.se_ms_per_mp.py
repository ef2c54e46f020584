"""Device milliseconds of UpCUNet's squeeze-and-excitation blocks (the
program's "w2x.cunet.se" spans: each tile's channel means, the two 1x1
products and the channel scale) per output megapixel of the window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.device_ms(("w2x.cunet.se",)))
