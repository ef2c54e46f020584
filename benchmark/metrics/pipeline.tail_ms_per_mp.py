"""Device milliseconds of the u8 tail (the program's "w2x.tail" spans:
pipeline._tail_u8_cmajor, _tail_u8_cmajor_noise, and under W2X_TAIL=kernel
_uv_phases_cmajor) per output megapixel of the window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.device_ms(("w2x.tail",)))
