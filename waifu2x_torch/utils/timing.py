"""Device timing and the card line that the tools and chip_smoke.py print."""

from __future__ import annotations

import subprocess
import time

import torch


def time_ms(fn, dev: torch.device, iters: int, graph: bool = False) -> float:
    """Mean time of fn(k) over `iters` calls k = 0.. after one warm-up
    call. On a card: CUDA events around the back-to-back calls, or with
    `graph` around one replay of a CUDA graph that captured them (after a
    replay to warm it), so that the host's cost of issuing a launch is not
    timed between kernels of a few µs; fn must then only enqueue work on
    the current stream. On the CPU: the host's clock."""
    if dev.type != "cuda":
        fn(0)
        t0 = time.perf_counter()
        for k in range(iters):
            fn(k)
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if not graph:
        fn(0)
        torch.cuda.synchronize(dev)
        start.record()
        for k in range(iters):
            fn(k)
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / iters
    # the warm-up runs on the capture stream, so that what a first call
    # sets up for its stream (a library's workspace) exists before capture
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for k in range(iters):
            fn(k)
    g.replay()
    torch.cuda.synchronize(dev)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    del g
    return start.elapsed_time(stop) / iters


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_line(dev: torch.device) -> str:
    """What a tool's times are: CUDA events on the named card, or the
    plain versions on the host's clock."""
    if dev.type != "cuda":
        return "plain versions on the host's clock: no device time"
    return f"CUDA events on {card_name()}"
