"""Host milliseconds a dispatch spends enqueueing its conversion steps
(the program's "w2x.scale_step" and "w2x.noise_step" spans, both in a
chain), over the window's dispatches."""

from benchmark import spans


def read(run):
    ms = spans.host_ms(spans.STEPS)
    if ms is None or not run.dispatches:
        return None
    return ms / run.dispatches
