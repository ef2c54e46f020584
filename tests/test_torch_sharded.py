"""The port's mesh primitives (waifu2x_torch/parallel/mesh.py) and its
sharded non-kernel stack (parallel/sharded.py) on 8 positions of the CPU
device, against the JAX package's parallel/sharded.py on its 8 virtual CPU
devices (XLA, no interpreter), on seeded numpy inputs.

Bars: the port's sharded plane is within 3e-5 of JAX's sharded plane (two
f32 convolution libraries) and, against its own monolithic plane, at the
JAX suite's bars for the same check (tests/test_sharded.py): 1e-6 on the
4-wide model, 5e-5 on the 7-layer one. The CPU's F.conv2d picks its
summation order by the plane's size (measured 1.5e-7 and 3.6e-6, oneDNN
on or off alike); the kernel path has no such dependence
(test_torch_mesh_pipeline.py holds it bit for bit). The mesh primitives
are exact copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models import ModelSpec as JModelSpec
from waifu2x_tpu.models import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.parallel import sharded as jsharded
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.convstack import convert_plane
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.parallel import sharded

torch.set_num_threads(2)

SMALL = JModelSpec.from_widths([1, 4, 4, 1])  # offset 3


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(m, "CPU_DEVICES", 8)


def _params(seed, spec):
    p = as_numpy(init_params(jax.random.PRNGKey(seed), spec))
    return p, params_from_numpy(p)


def _jax_mesh(shape):
    return jsharded.make_mesh(shape, jax.devices()[:shape[0] * shape[1]])


def _cpu_mesh(shape):
    return sharded.make_mesh(shape, m.local_devices("cpu"))


@pytest.mark.parametrize("mesh_shape", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_sharded_matches_jax(rng, mesh_shape):
    pj, pt = _params(0, SMALL)
    y = rng.random((48, 64), dtype=np.float32)
    ref = np.asarray(jsharded.convert_plane_on_mesh(
        jnp.asarray(y), pj, _jax_mesh(mesh_shape)))
    got = sharded.convert_plane_on_mesh(torch.from_numpy(y), pt,
                                        _cpu_mesh(mesh_shape))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
    mono = convert_plane(torch.from_numpy(y), pt)
    torch.testing.assert_close(got, mono, rtol=0, atol=1e-6)


def test_sharded_non_divisible_shape(rng):
    """pad_to_mesh takes sizes that do not divide the mesh."""
    pj, pt = _params(1, SMALL)
    y = rng.random((45, 61), dtype=np.float32)
    ref = np.asarray(jsharded.convert_plane_on_mesh(
        jnp.asarray(y), pj, _jax_mesh((2, 4))))
    got = sharded.convert_plane_on_mesh(torch.from_numpy(y), pt,
                                        _cpu_mesh((2, 4)))
    assert got.shape == (45, 61)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
    torch.testing.assert_close(got, convert_plane(torch.from_numpy(y), pt),
                               rtol=0, atol=1e-6)


def test_sharded_full_arch(rng):
    """The 7-layer model (offset 7): a halo of 7 across a 2x4 mesh."""
    pj, pt = _params(2, JFLAGSHIP)
    y = rng.random((32, 64), dtype=np.float32)
    ref = np.asarray(jsharded.convert_plane_on_mesh(
        jnp.asarray(y), pj, _jax_mesh((2, 4))))
    got = sharded.convert_plane_on_mesh(torch.from_numpy(y), pt,
                                        _cpu_mesh((2, 4)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
    torch.testing.assert_close(got, convert_plane(torch.from_numpy(y), pt),
                               rtol=0, atol=5e-5)


def test_pad_to_mesh_roundtrip(rng):
    y = rng.random((13, 10), dtype=np.float32)
    yp, (h, w) = sharded.pad_to_mesh(torch.from_numpy(y), _cpu_mesh((2, 4)))
    jyp, jhw = jsharded.pad_to_mesh(jnp.asarray(y), _jax_mesh((2, 4)))
    assert yp.shape == (14, 12) and (h, w) == (13, 10) == jhw
    np.testing.assert_array_equal(yp.numpy(), np.asarray(jyp))
    np.testing.assert_array_equal(yp.numpy()[13], yp.numpy()[12])


def test_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        sharded.make_mesh((3, 3), m.local_devices("cpu"))
    with pytest.raises(ValueError, match="devices"):
        jsharded.make_mesh((3, 3))


# --- the primitives (parallel/mesh.py) ---------------------------------------

@pytest.mark.parametrize("spec", [("dy", "dx", None), (None, "dy", "dx"),
                                  ("dx", None, None)])
def test_shard_gather_roundtrip(rng, spec):
    mesh = _cpu_mesh((2, 4))
    x = torch.from_numpy(rng.random((8, 16, 4), dtype=np.float32))
    s = m.shard(x, mesh, spec)
    assert len(s.blocks) == 8
    for pos, b in s.blocks.items():
        torch.testing.assert_close(b, x[s.index(pos)], rtol=0, atol=0)
    torch.testing.assert_close(m.gather(s), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="pad first"):
        m.shard(x[:, :15], mesh, ("dy", "dx", None))


def test_gather_one_row(rng):
    mesh = _cpu_mesh((2, 4))
    x = torch.from_numpy(rng.random((6, 8), dtype=np.float32))
    s = m.shard(x, mesh, ("dy", "dx"))
    torch.testing.assert_close(m.gather(s, dy=1), x[3:], rtol=0, atol=0)
    torch.testing.assert_close(m.gather(s, dx=2), x[:, 4:6], rtol=0, atol=0)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (1, 1)])
@pytest.mark.parametrize("k", [1, 3])
def test_halo_is_the_padded_plane(rng, mesh_shape, k):
    """Rows then columns: every extended block is its window of the whole
    plane edge-padded by k, corners included."""
    mesh = sharded.make_mesh(mesh_shape,
                             m.local_devices("cpu")[:np.prod(mesh_shape)])
    y = torch.from_numpy(rng.random((16, 24), dtype=np.float32))
    ext = sharded._halo_extend(m.shard(y, mesh, ("dy", "dx")), k)
    pad = torch.from_numpy(np.pad(y.numpy(), k, mode="edge"))
    bh, bw = 16 // mesh_shape[0], 24 // mesh_shape[1]
    for (i, j), b in ext.blocks.items():
        assert b.shape == (bh + 2 * k, bw + 2 * k)
        torch.testing.assert_close(
            b, pad[i * bh:i * bh + bh + 2 * k, j * bw:j * bw + bw + 2 * k],
            rtol=0, atol=0)
    assert ext.shape == (mesh_shape[0] * (bh + 2 * k),
                         mesh_shape[1] * (bw + 2 * k))


def test_halo_narrow_shard_raises(rng):
    y = torch.from_numpy(rng.random((8, 16), dtype=np.float32))
    s = m.shard(y, _cpu_mesh((1, 8)), ("dy", "dx"))
    with pytest.raises(ValueError, match="halo"):
        m.halo(s, 3, "dx", 1)


def test_shard_map_runs_each_position(rng):
    mesh = _cpu_mesh((2, 4))
    x = torch.from_numpy(rng.random((4, 8, 3), dtype=np.float32))
    s = m.shard(x, mesh, ("dy", "dx", None))
    out = m.shard_map(lambda b: b[..., 0] * 2, s, spec=("dy", "dx"))
    assert out.shape == (4, 8)
    torch.testing.assert_close(m.gather(out), x[..., 0] * 2, rtol=0, atol=0)


def test_to_device_moves_every_stack_attribute():
    """replicate's copy of a StackParams carries every attribute, whatever
    its name, in both storage types (the meta device stands in for a second
    card)."""
    _, pt = _params(4, JFLAGSHIP)
    for dtype in (torch.float32, torch.bfloat16):
        sp = stack.prep_params(pt, dtype, "cpu")
        moved = m.to_device(sp, "meta")
        assert type(moved) is type(sp) and len(moved) == len(sp)
        assert set(vars(moved)) == set(vars(sp))

        def tensors(obj):
            if isinstance(obj, torch.Tensor):
                yield obj
            elif isinstance(obj, (tuple, list)):
                for v in obj:
                    yield from tensors(v)
                for v in getattr(obj, "__dict__", {}).values():
                    yield from tensors(v)

        before, after = list(tensors(sp)), list(tensors(moved))
        assert len(after) == len(before) > 20
        assert all(t.device.type == "meta" for t in after)
        assert [t.shape for t in after] == [t.shape for t in before]


def test_replicate_one_copy_per_device(rng):
    mesh = _cpu_mesh((2, 4))
    reps = m.replicate({"w": torch.ones(3)}, mesh)
    assert list(reps) == [torch.device("cpu")]
    assert m.local_devices("cpu") == [torch.device("cpu")] * 8
