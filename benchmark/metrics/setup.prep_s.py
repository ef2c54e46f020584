"""Host seconds of the program's weight preparation in set-up (its
"w2x.setup.prep" spans: FastStack.build, packing every form of each
stack's layers and uploading them)."""

from benchmark import spans


def read(run):
    ms = spans.host_ms(("w2x.setup.prep",))
    return None if ms is None else ms * 1e-3
