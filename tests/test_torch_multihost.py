"""The port's multi-process plumbing (waifu2x_torch/parallel/multihost.py)
against the JAX package's: the global mesh's layouts, each process's frames
placed on its own positions, the scaling report; and a real 2-process gloo
group on localhost (waifu2x_torch/tools/multiproc_worker.py), whose
sharded 2x step, with "dp" and then "sp" across the two processes (a halo
that crosses them), each process holds bit-equal to the single-process
step, and whose sharded train step ("dp" across the processes, gradients
all-reduced) each holds within 1e-5 in loss of the single-process step."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from waifu2x_tpu.parallel import multihost as jmh
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.parallel import multihost
from waifu2x_torch.parallel.fast_sharded import scale2x_u8_s2d_sharded

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(m, "CPU_DEVICES", 8)


@pytest.mark.parametrize("dp,sp", [(None, None), (2, None), (None, 2),
                                   (4, 2), (1, 8)])
def test_global_mesh_layouts_match_jax(dp, sp):
    mesh = multihost.global_mesh(dp, sp, device="cpu")
    jmesh = jmh.global_mesh(dp, sp)
    assert mesh.axis_names == tuple(jmesh.axis_names) == ("dp", "sp")
    assert mesh.shape == jmesh.devices.shape
    assert mesh.owners is None and mesh.rank == 0   # one process


def test_global_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        multihost.global_mesh(3, 3, device="cpu")


def test_shard_host_batch_and_sharded_convert(rng):
    mesh = multihost.global_mesh(dp=2, sp=4, device="cpu")
    fast = pl.FastStack.build(init_params(5), scale_input=True,
                              dtype=torch.float32, device="cpu")
    local = rng.random((4, 16, 32, 3), dtype=np.float32)
    batch = multihost.shard_host_batch(local, mesh)
    assert batch.shape == local.shape   # one process: the whole batch
    got = m.gather(scale2x_u8_s2d_sharded(batch, fast, mesh))
    ref = pl.scale2x_batch_u8_s2d(torch.from_numpy(local), fast)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_shard_local_places_only_this_process_blocks(rng):
    """Rank 1 of two, "sp" across both (positions 4-7 its own): its part of
    the width lands on its positions at the global indices, and no block of
    rank 0's positions exists here."""
    owners = np.repeat(np.arange(2), 4).reshape(1, 8)
    mesh = m.Mesh(np.array([torch.device("cpu")] * 8,
                           dtype=object).reshape(1, 8),
                  ("dp", "sp"), owners, rank=1)
    frames = rng.random((2, 8, 40, 3), dtype=np.float32)
    mine = torch.from_numpy(np.ascontiguousarray(frames[:, :, 20:]))
    s = m.shard_local(mine, mesh, ("dp", None, "sp", None))
    assert s.shape == frames.shape
    assert sorted(s.blocks) == [(0, j) for j in range(4, 8)]
    for pos, b in s.blocks.items():
        np.testing.assert_array_equal(b.numpy(), frames[s.index(pos)])
    with pytest.raises(ValueError, match="every block"):
        m.gather(s)


def test_scaling_report_matches_jax():
    for args in ((4, 640.0, 200.0), (1, 100.0), (8, 950.0, 130.0)):
        r, jr = multihost.ScalingReport(*args), jmh.ScalingReport(*args)
        assert r.efficiency == jr.efficiency
        assert r.line() == jr.line()
    assert "efficiency 80.0%" in multihost.ScalingReport(4, 640.0,
                                                         200.0).line()


def test_measure_throughput_counts_every_call():
    calls = []
    report = multihost.measure_throughput(calls.append, "batch", 2_000_000,
                                          iters=3, devices=4)
    assert calls == ["batch"] * 4   # a warm-up and three timed calls
    assert report.devices == 4 and report.mp_per_s > 0
    assert report.efficiency is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group():
    port = _free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "waifu2x_torch.tools.multiproc_worker",
         "--coord", f"localhost:{port}", "--procs", "2", "--rank", str(r),
         "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"rank {r}: OK (2 processes, 8 positions)" in out, out
        assert f"rank {r}: cross-process halo exchange OK" in out, out
        assert f"rank {r}: train step loss" in out, out
        print(next(line for line in out.splitlines()
                   if "train step loss" in line))
