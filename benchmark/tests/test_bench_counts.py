"""The yardstick's counts against figures worked out by hand."""

import pytest

from benchmark import counts
from benchmark.counts import StackCall


def test_macs_per_output_pixel():
    # 9 x (1*32 + 32*32 + 32*64 + 64*64 + 64*128 + 128*128 + 128*1)
    assert counts.MAC_PER_PX == 9 * 31904 == 287136
    assert counts.flops_per_px() == 574272


def test_scale512_batch_flops():
    call = StackCall("scale", "bfloat16", 16, 512, 512)
    assert call.out_px() == 16 * 1024 * 1024
    tflop = call.out_px() * counts.flops_per_px() / 1e12
    assert tflop == pytest.approx(9.63, abs=5e-3)   # 9.6346
    # at 989 TFLOP/s: 9.74 ms
    assert tflop / 989 * 1e3 == pytest.approx(9.74, abs=5e-3)


def test_a_calls_flops_are_its_output_times_the_rate():
    for call in (StackCall("scale", "bfloat16", 16, 512, 512),
                 StackCall("noise", "float32", 4, 1081, 1920)):
        assert call.flops() == call.out_px() * 574272
    assert StackCall("scale", "bfloat16", 16, 512, 512).flops() == \
        9_634_685_386_752


def test_planes_shrink_by_two_a_layer():
    call = StackCall("scale", "bfloat16", 1, 512, 512)
    assert [call.plane(k) for k in (1, 6, 7)] == [
        (1036, 1036), (1026, 1026), (1024, 1024)]
    noise = StackCall("noise", "float32", 1, 1081, 1920)
    assert noise.cells == (541, 960)
    assert noise.plane(7) == (1082, 1920)


def test_layer2_bytes_and_ops_by_hand():
    call = StackCall("scale", "bfloat16", 16, 512, 512)
    # layer 2: 32 -> 32 from x1 [16, 1036, 1036, 32] to x2 [16, 1034, ...]
    read = 16 * 32 * 1036 * 1036 * 2
    write = 16 * 32 * 1034 * 1034 * 2
    assert call.layer_bytes(2) == read + write + 9 * 32 * 32 * 2
    assert call.layer_ops(2) == 2 * 9 * 32 * 32 * 16 * 1034 * 1034
    # bound by bytes: 2.19 GB at 3.35 TB/s, 0.65 ms
    assert call.bound_s(call.layer_ops(2), call.layer_bytes(2)) == \
        pytest.approx(call.layer_bytes(2) / 3.35e12)


def test_layer6_bound_by_operations():
    call = StackCall("scale", "bfloat16", 16, 512, 512)
    ops, nbytes = call.layer_ops(6), call.layer_bytes(6)
    assert ops / 989e12 > nbytes / 3.35e12
    assert call.bound_s(ops, nbytes) == pytest.approx(ops / 989e12)


def test_f32_priced_at_tf32():
    call = StackCall("noise", "float32", 4, 1080, 1920)
    ops = call.layer_ops(6)
    assert call.bound_s(ops, 0) == pytest.approx(ops / 495e12)
