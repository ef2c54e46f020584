"""Device milliseconds of UpCUNet's tiling (the program's "w2x.cunet.tiles"
spans: the frame's pad and the cut into tiles, and the tiles' u8 outputs
stitched into frames) per output megapixel of the window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.device_ms(("w2x.cunet.tiles",)))
