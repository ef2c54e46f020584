"""The port's StreamConverter.process_paths and frame cursor
(waifu2x_torch.stream, waifu2x_torch.train.checkpoint) on the CPU: files
through the stream equal to process_frames bit for bit, resume from a
cursor as tests/test_stream.py holds the JAX package's, and one cursor file
shared by both packages."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.train import checkpoint as jckpt
from waifu2x_torch import io as tio
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.stream import StreamConverter
from waifu2x_torch.train import checkpoint as tckpt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fast():
    params = as_numpy(init_params(jax.random.PRNGKey(2), JFLAGSHIP))
    return pl.FastStack.build(params_from_numpy(params), True,
                              dtype=torch.float32, device="cpu")


def _files(tmp_path, rng, n, shape=(16, 16, 3)):
    paths, outs, imgs = [], [], []
    for i in range(n):
        img = rng.integers(0, 256, shape, np.uint8)
        paths.append(str(tmp_path / f"in{i}.png"))
        outs.append(str(tmp_path / f"out{i}.png"))
        tio.imwrite_bgr(paths[-1], img)
        imgs.append(img)
    return paths, outs, imgs


def test_process_paths_equals_process_frames(fast, rng, tmp_path):
    paths, outs, imgs = _files(tmp_path, rng, 5)
    # two sizes interleaved: per-shape batches, outputs in input order
    big = rng.integers(0, 256, (12, 20, 3), np.uint8)
    tio.imwrite_bgr(paths[2], big)
    imgs[2] = big
    sc = StreamConverter(fast, batch=2, device="cpu")
    sc.process_paths(paths, outs, jobs=2)
    want = list(sc.process_frames(imgs))
    for op, w in zip(outs, want):
        np.testing.assert_array_equal(tio.imread_bgr(op), w)
    assert tio.imread_bgr(outs[2]).shape == (24, 40, 3)


def test_process_paths_checkpoint_resume(fast, rng, tmp_path):
    paths, outs, _ = _files(tmp_path, rng, 5)
    ckpt = str(tmp_path / "cursor.json")
    sc = StreamConverter(fast, batch=2, device="cpu")
    sc.process_paths(paths[:3], outs[:3], checkpoint=ckpt)
    assert json.load(open(ckpt))["cursor"] == 3
    assert not os.path.exists(ckpt + ".tmp")
    # resume over the full list: frames 0-2 are skipped (their outputs
    # untouched), 3-4 produced
    mtimes = [os.path.getmtime(o) for o in outs[:3]]
    sc.process_paths(paths, outs, checkpoint=ckpt)
    assert [os.path.getmtime(o) for o in outs[:3]] == mtimes
    for o in outs:
        assert tio.imread_bgr(o).shape == (32, 32, 3)
    assert json.load(open(ckpt))["cursor"] == 5
    # a cursor at the end: no work, no error, nothing written
    before = sorted(os.listdir(tmp_path))
    mtimes = [os.path.getmtime(o) for o in outs]
    sc.process_paths(paths, outs, checkpoint=ckpt)
    assert sorted(os.listdir(tmp_path)) == before
    assert [os.path.getmtime(o) for o in outs] == mtimes


@pytest.mark.parametrize("writer,reader", [
    (jckpt.save_frame_cursor, tckpt.load_frame_cursor),
    (tckpt.save_frame_cursor, jckpt.load_frame_cursor),
    (tckpt.save_frame_cursor, tckpt.load_frame_cursor)])
def test_cursor_shared_by_both_packages(tmp_path, writer, reader):
    p = str(tmp_path / "cursor.json")
    writer(p, 7, {"paths": 12})
    assert reader(p) == 7
    assert json.load(open(p)) == {"cursor": 7, "paths": 12}


def test_port_resumes_a_jax_cursor(fast, rng, tmp_path):
    paths, outs, imgs = _files(tmp_path, rng, 4)
    ckpt = str(tmp_path / "cursor.json")
    jckpt.save_frame_cursor(ckpt, 2)
    StreamConverter(fast, batch=3, device="cpu").process_paths(
        paths, outs, checkpoint=ckpt)
    assert [os.path.exists(o) for o in outs] == [False, False, True, True]
    assert jckpt.load_frame_cursor(ckpt) == 4


@pytest.mark.parametrize("content", [None, "", "{\"cursor\": ", "[1, 2]",
                                     "{\"frames\": 3}", "{\"cursor\": null}",
                                     "{\"cursor\": \"x\"}"])
def test_missing_or_torn_cursor_means_frame_zero(tmp_path, content):
    p = tmp_path / "cursor.json"
    if content is not None:
        p.write_text(content)
    assert tckpt.load_frame_cursor(str(p)) == 0
