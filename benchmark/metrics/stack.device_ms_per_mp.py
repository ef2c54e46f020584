"""Device milliseconds of the program's stack calls (its "w2x.stack" spans:
ops/stack.py's entries, from the first launch's buffers to the last
launch, the gaps between launches and stack_noise's d2s and crop
included) per output megapixel of the window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.device_ms(("w2x.stack",)))
