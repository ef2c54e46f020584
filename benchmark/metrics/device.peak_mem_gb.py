"""torch.cuda.max_memory_allocated() over the window (its statistics reset
before the window), in GB of 1e9 bytes."""


def read(run):
    return run.peak_mem_bytes / 1e9 if run.peak_mem_bytes else None
