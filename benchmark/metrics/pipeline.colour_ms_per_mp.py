"""Device milliseconds of the colour map (the program's "w2x.colour" spans:
ops/color.u8_to_unit_f32 and bgr_to_yuv) per output megapixel of the
window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.device_ms(("w2x.colour",)))
