"""One run of one cell: set-up, the timed window, the per-layer readers and
the check against the reference.

The window drives the port's batched conversion step, the product's unit
of work: a pinned u8 BGR batch is uploaded without blocking, prepared and
converted by the program the configuration names, and its u8 result
copied into pinned host memory without blocking; an event marks the
dispatch's end. It is a closed loop with `depth` dispatches in flight:
dispatch i is enqueued as soon as dispatch i - depth has ended.

The architecture is the configuration's: its `program` (benchmark/
families/<f>.py: `build`, `STRIP_ROWS`) builds the port's model by its
public set-up and drives its step, and its `reference` (benchmark/
reference/<f>.py: `weights`, `convert_by_role`, `LOWER`) makes the stacks'
weights and the plain conversion the check compares with. This file names
no architecture.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "waifu2x_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return dict(read_json(BENCH / "workloads" / f"{name}.json"), name=name)


def config(name: str) -> dict:
    return dict(read_json(BENCH / "configs" / f"{name}.json"), name=name)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def set_env(wl: dict) -> None:
    """The workload's switches of the program, before it is imported."""
    for key, value in wl.get("env", {}).items():
        if not key.startswith("W2X_"):
            raise ValueError(f"workload env may set W2X_* only, not {key}")
        os.environ[key] = str(value)


# -- traffic --------------------------------------------------------------

@dataclasses.dataclass
class Batch:
    group: int
    n: int
    h: int
    w: int
    host: object          # u8 BGR [n, h, w, 3], pinned on a card


class Traffic:
    """The seed's frames and dispatch order, from a workload's parameters:
    `groups` of frames of one size, `per_dispatch` to a batch; every pass
    dispatches each batch once, in an order drawn anew from the seed; of
    each group `check_per_group` batches, drawn from the seed, are
    compared with the reference. Every seed gives the same set of batch
    shapes; only the pixels and the orders change."""

    def __init__(self, wl: dict, seed: int, device, generate):
        rng = np.random.default_rng(seed & (2 ** 64 - 1))
        self.batches, self.checked = [], []
        for g, grp in enumerate(wl["groups"]):
            per, total = grp["per_dispatch"], grp["frames"]
            if total % per:
                raise ValueError(f"group {g}: {total} frames do not split "
                                 f"into batches of {per}")
            frames = generate(int(rng.integers(2 ** 62)), total, grp["h"],
                              grp["w"], device)
            first = len(self.batches)
            for k in range(total // per):
                self.batches.append(Batch(g, per, grp["h"], grp["w"],
                                          frames[k * per:(k + 1) * per]))
            picks = rng.choice(total // per, grp["check_per_group"],
                               replace=False)
            self.checked += sorted(first + int(p) for p in picks)
        self._orders = np.random.default_rng(int(rng.integers(2 ** 62)))

    def next_pass(self) -> list:
        return [int(b) for b in self._orders.permutation(len(self.batches))]


def image_like(seed: int, n: int, h: int, w: int, device, pin: bool):
    """Seeded u8 BGR frames with image-like structure: a smooth random field
    (the bilinear upscale of a grid of one value per 32 pixels) plus
    sensor-like noise of 6 levels, made on the device in one call each and
    copied to (pinned) host memory."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    coarse = torch.rand((n, 3, h // 32 + 1, w // 32 + 1), generator=g,
                        device=device)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    noise = torch.randn((n, h, w, 3), generator=g, device=device)
    img = torch.clamp(torch.round(smooth * 255.0 + 6.0 * noise), 0, 255)
    host = torch.empty((n, h, w, 3), dtype=torch.uint8, pin_memory=pin)
    host.copy_(img.to(torch.uint8))
    return host


# -- the program ----------------------------------------------------------

def load_module(path: str):
    """The module at `path`, a file under benchmark/ named relative to the
    checkout's root (a configuration's `program` or `reference`), loaded by
    its path once a process."""
    file = (ROOT / path).resolve()
    if BENCH not in file.parents or file.suffix != ".py":
        raise ValueError(f"{path}: not a Python file under benchmark/")
    name = "bench_" + "_".join(file.relative_to(BENCH).with_suffix("").parts)
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, file)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod     # as an import would: dataclasses look
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def stack_weights(cfg: dict, device) -> dict:
    """role -> weights of each of the configuration's stacks, as its plain
    reference makes them (`weights`: a model file held to its sha256, or
    drawn from the stack's seed)."""
    ref = load_module(cfg["reference"])
    return {s["role"]: ref.weights(s, ROOT, device) for s in cfg["stacks"]}


def program(cfg: dict, device):
    """The program the window drives: the configuration's adapter
    (`program`) built from its stacks' weights. It has `device` (a
    `torch.device`), `prepare(x_u8)`, `step(prepared) -> (out, aux)`,
    `out_shape(batch)`, `out_px(batch)`, `calls(batch)` (what the
    yardstick counts: each with a `dtype` and `flops()`) and `frames(out)`
    (u8 [n, H, W, 3] on the device)."""
    return load_module(cfg["program"]).build(
        cfg, stack_weights(cfg, device), device)


# -- the window -----------------------------------------------------------

class Clock:
    """Marks in the device's stream order, read on its clock (CUDA events);
    on the CPU, where every operation has ended when it returns, the
    host's clock."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        import torch
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclasses.dataclass
class Window:
    seconds: float              # host clock, first enqueue to last event
    order: list                 # batch index of each dispatch
    latency_ms: list            # each dispatch's, see run_window
    outputs: dict               # checked batch -> step's u8 result (host)
    planes: dict                # checked batch -> step's aux (device)


def span(name: str):
    import torch
    return torch.profiler.record_function(name)


def run_window(prog, traffic: Traffic, seconds: float, depth: int,
               step=None) -> Window:
    """The closed loop: dispatches until `seconds` have passed on the host's
    clock and every batch has run at least once, then waits for the last.
    A dispatch's latency runs from the end of dispatch i - depth (the
    window's start for the first `depth`), when the loop enqueues it, to
    its own end, both marks on the device's clock. The checked batches
    copy their results into buffers of their own, which after the window
    hold each one's last dispatch."""
    import torch
    step = step or prog.step
    dev, clock = prog.device, Clock(prog.device)
    pin = dev.type == "cuda"
    out_bytes = max(np.prod(prog.out_shape(b)) for b in traffic.batches)
    ring = [torch.empty(int(out_bytes), dtype=torch.uint8, pin_memory=pin)
            for _ in range(depth)]
    outputs = {b: torch.empty(prog.out_shape(traffic.batches[b]),
                              dtype=torch.uint8, pin_memory=pin)
               for b in traffic.checked}
    planes, order, marks = {}, [], []
    passes = 0
    with span("bench.window"):
        t0 = time.perf_counter()
        start = clock.mark()
        deadline = t0 + seconds
        while passes == 0 or time.perf_counter() < deadline:
            for b in traffic.next_pass():
                if passes and time.perf_counter() >= deadline:
                    break
                if len(marks) >= depth:
                    with span("bench.wait"):
                        clock.wait(marks[-depth])
                batch = traffic.batches[b]
                with span("bench.upload"):
                    x = batch.host.to(dev, non_blocking=True)
                with span("bench.colour"):
                    xin = prog.prepare(x)
                with span("bench.step"):
                    out, aux = step(xin)
                with span("bench.download"):
                    if b in outputs:
                        dst = outputs[b]
                    else:
                        dst = ring[len(order) % depth][:out.numel()].view(
                            out.shape)
                    dst.copy_(out, non_blocking=True)
                    marks.append(clock.mark())
                if b in outputs and aux is not None:
                    planes[b] = aux
                order.append(b)
                del x, xin, out, aux
            passes += 1
        with span("bench.wait"):
            clock.wait(marks[-1])
        t1 = time.perf_counter()
    lat = [clock.ms(marks[i - depth] if i >= depth else start, marks[i])
           for i in range(len(marks))]
    return Window(t1 - t0, order, lat, outputs, planes)


# -- readers --------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell, the window's dispatches and
    the calls they made (`calls`: the program's calls, such as
    `counts.StackCall`, -> count), its timings
    (`latency_ms` and `sizes`, the frames' (h, w), one of each a dispatch
    in the window's order), the program's counters over the window, and
    with --trace 1 the trace and the names of the program's kernels."""

    cell: str
    config: dict
    workload: dict
    setup_s: float
    window_s: float
    dispatches: int
    out_px: int
    latency_ms: list
    calls: dict
    counters: dict
    peak_mem_bytes: int
    sizes: list = dataclasses.field(default_factory=list)
    trace: object = None
    kernels: frozenset = frozenset()

    def kernel_seconds(self, names) -> float:
        """Device seconds of the program's kernels named in `names`."""
        from benchmark.trace import base_name
        if self.trace is None:
            return 0.0
        return self.trace.seconds(lambda n: base_name(n) in names)


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, entries: list) -> dict:
    """name -> {"value", "unit"} for each entry of the cell (all cells where
    it lists none) its reader found something for, in the manifest's
    order."""
    out = {}
    for m in entries:
        if "workloads" in m and run.cell not in m["workloads"]:
            continue
        v = load_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# -- the check ------------------------------------------------------------

def reference_outputs(cfg: dict, traffic: Traffic, device, batches,
                      precisions=None):
    """Yields (batch, (u8 frames [n, H, W, 3], aux or None)) of the plain
    reference for each of `batches`, the configuration's stacks by role,
    their weights made anew by the reference; `precisions` (role ->
    precision, f32 where none is given) puts a lower-precision control in
    the program's place."""
    ref = load_module(cfg["reference"])
    weights = stack_weights(cfg, device)
    for b in batches:
        x = traffic.batches[b].host.to(device)
        yield b, ref.convert_by_role(x, weights, precisions)


def control_precisions(cfg: dict) -> dict:
    """role -> precision of the control: each stack one step below the
    type the configuration states (the reference's `LOWER`)."""
    lower = load_module(cfg["reference"]).LOWER
    return {s["role"]: lower[s["dtype"]] for s in cfg["stacks"]}


def control_outputs(cfg: dict, traffic: Traffic, device) -> dict:
    """The control in the program's place: batch -> (u8 frames, aux or
    None) of the reference computed one precision lower."""
    return dict(reference_outputs(cfg, traffic, device, traffic.checked,
                                  control_precisions(cfg)))


def check(cfg: dict, wl: dict, traffic: Traffic, got: dict, device):
    """`got` (batch -> (u8 frames [n, H, W, 3], aux or None)) for every
    checked batch against the reference's, with the configuration's and the
    workload's limits -> (the numbers over all of them, how many batches
    failed a limit). A batch with no result fails. A strip is the
    program's `STRIP_ROWS` output rows."""
    from benchmark.check import Numbers
    strip = load_module(cfg["program"]).STRIP_ROWS
    limits = {"frame_psnr_min_db": cfg["fidelity_db"], **wl["limits"]}
    total, failed = Numbers(limits), 0
    for b, (ref_frames, ref_aux) in reference_outputs(cfg, traffic, device,
                                                      traffic.checked):
        one = Numbers(limits)
        if b in got:
            frames, aux = got[b]
            one.add_frames(frames.to(device), ref_frames, strip)
            if ref_aux is not None and aux is not None:
                one.add_plane(aux.to(device), ref_aux)
        total.merge(one)
        failed += not one.ok()
    return total, failed


def program_outputs(prog, window: Window, device) -> dict:
    """batch -> (u8 frames, aux or None) the window left for each checked
    batch."""
    return {b: (prog.frames(out.to(device)), window.planes.get(b))
            for b, out in window.outputs.items()}


# -- one run --------------------------------------------------------------

def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(wl: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, step_wrap=None, log=print) -> dict:
    """One run of the cell `wl` (a workload dict with its "name") ->
    the result line's object. `step_wrap`, given the program's step,
    returns the step the window drives instead (the tests' faults)."""
    import torch
    set_env(wl)
    cfg = config(wl["config"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    prog = program(cfg, dev)
    t_prog = time.perf_counter()
    gen = (lambda s, n, h, w, d: image_like(s, n, h, w, d, on_card))
    traffic = Traffic(wl, seed, dev, gen)
    t_frames = time.perf_counter()
    step = step_wrap(prog.step) if step_wrap else prog.step
    depth = int(wl["depth"])
    # warm-up: one whole pass, every shape of the cell, as the window runs
    run_window(prog, traffic, 0.0, depth, step)
    if on_card:
        torch.cuda.synchronize(dev)
    from waifu2x_torch.ops import stack
    stack.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    window = run_window(prog, traffic, seconds, depth, step)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = stack.LAUNCHES
    calls = collections.Counter()
    for b in window.order:
        for c in prog.calls(traffic.batches[b]):
            calls[c] += 1
    out_px = sum(prog.out_px(traffic.batches[b]) for b in window.order)
    sizes = [(traffic.batches[b].h, traffic.batches[b].w)
             for b in window.order]
    run = Run(wl["name"], cfg, wl, setup_s, window.seconds,
              len(window.order), out_px, window.latency_ms, dict(calls),
              {"stack.LAUNCHES": launches}, peak, sizes)
    man = manifest()
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": (torch.cuda.get_device_name(dev) if on_card
                              else "cpu"),
                     "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from benchmark import trace as tr
        run.trace = tr.from_profiler(prof)
        run.kernels = tr.program_kernels(ROOT / "waifu2x_torch" / "csrc")
        del prof
        metrics = read_metrics(run, man["per_layer"])
        result_device["busy_s"] = run.trace.busy_s()
        result_device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
    else:
        metrics = read_metrics(run, man["end_to_end"])
    log(f"card: {card_line() if on_card else 'none (cpu)'}")
    log(f"setup: to the program built {t_prog - t_start:.3f} s, frames "
        f"{t_frames - t_prog:.3f} s, warm-up pass "
        f"{t_start + setup_s - t_frames:.3f} s")
    log(f"window: {window.seconds:.4f} s, {len(window.order)} dispatches, "
        f"{out_px / 1e6:.3f} MP out; batch latency p95 over "
        f"{len(window.latency_ms)} dispatches; setup {setup_s:.4f} s")
    # the program's state goes before the reference runs on the device
    got = program_outputs(prog, window, dev)
    del window, prog, step
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, failed = check(cfg, wl, traffic, got, dev)
    log(f"reference and check: {time.perf_counter() - t_ref:.3f} s")
    table = nums.table()
    for name, row in table.items():
        rel = ">=" if name.endswith("_db") else "<="
        log(f"check {name} {row['value']} {rel} {row['limit']} "
            f"{'ok' if row['pass'] else 'FAIL'}")
    # attempted: the window's dispatches; failed: the checked batches
    # (each as its last dispatch left it) that missed a limit
    result = {"correct": nums.ok(), "attempted": run.dispatches,
              "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": r["value"], "limit": r["limit"]}
                        for k, r in table.items()}
    return result
