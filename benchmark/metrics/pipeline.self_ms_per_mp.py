"""Device milliseconds of the conversion steps (the program's
"w2x.scale_step" and "w2x.noise_step" spans) that no stack, tail or colour
span below them covers (the casts to the stack's type, band slices and
their concatenation, the chain's handoff) per output megapixel of the
window."""

from benchmark import spans


def read(run):
    return spans.per_mp(run, spans.self_ms())
