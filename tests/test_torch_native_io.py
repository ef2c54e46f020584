"""The port's host I/O (waifu2x_torch.native, waifu2x_torch.io and the
native d2s_host) against the JAX package's, on seeded numpy images.

Both packages bind the same shared library (native/libw2x_host.so), so
every comparison here is exact: equal pixels, equal PNG bytes."""

import os
import subprocess
import sys

import numpy as np
import pytest

from waifu2x_tpu import io as jio
from waifu2x_tpu import native as jnative
from waifu2x_tpu.ops.s2d import d2s_host as jd2s_host
from waifu2x_torch import io as tio
from waifu2x_torch import native as tnative
from waifu2x_torch import pngcodec
from waifu2x_torch.ops import s2d as ts2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (37, 53, 3), np.uint8)


def test_native_loads_the_shared_library():
    assert tnative.available() and jnative.available()
    assert tnative._LIB_PATH == jnative._LIB_PATH


def test_png_roundtrip_exact_across_packages(tmp_path, img):
    p, q = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert tnative.imwrite_png(p, img) and jnative.imwrite_png(q, img)
    for path in (p, q):
        np.testing.assert_array_equal(tnative.imread(path), img)
        np.testing.assert_array_equal(jnative.imread(path), img)


def test_png_bgra_across_packages(tmp_path, rng):
    bgra = rng.integers(0, 256, (8, 10, 4), np.uint8)
    p = str(tmp_path / "a.png")
    assert tnative.imwrite_png(p, bgra)
    np.testing.assert_array_equal(tnative.imread(p, keep_alpha=True), bgra)
    np.testing.assert_array_equal(jnative.imread(p, keep_alpha=True), bgra)
    # without keep_alpha the reader strips to 3 channels (IMREAD_COLOR)
    np.testing.assert_array_equal(tnative.imread(p), jnative.imread(p))
    assert tnative.imread(p).shape == (8, 10, 3)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_d2s_u8_matches_jax_and_numpy(rng, lead):
    src = rng.integers(0, 256, (*lead, 9, 13, 12), np.uint8)
    got = tnative.d2s_u8(src)
    np.testing.assert_array_equal(got, jnative.d2s_u8(src))
    np.testing.assert_array_equal(got, jd2s_host(src))
    assert got.shape == (*lead, 18, 26, 3)


def test_decode_batch_threads_match_jax(tmp_path, rng):
    paths, imgs = [], []
    for i in range(7):
        im = rng.integers(0, 256, (11 + i, 17, 3), np.uint8)
        p = str(tmp_path / f"f{i}.png")
        tnative.imwrite_png(p, im)
        paths.append(p)
        imgs.append(im)
    paths.append(str(tmp_path / "missing.png"))
    for threads in (1, 3):
        got = tnative.decode_batch(paths, threads=threads)
        want = jnative.decode_batch(paths, threads=threads)
        assert got[-1] is None and want[-1] is None
        for g, w, im in zip(got, want, imgs):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, im)
    assert tnative.decode_batch([], threads=2) == []


def test_flatten_white_matches_jax_and_numpy(rng):
    bgra = rng.integers(0, 256, (19, 23, 4), np.uint8)
    bgra[0, :4, 3] = (0, 255, 1, 254)     # the alpha extremes
    got = tnative.flatten_white(bgra)
    np.testing.assert_array_equal(got, jnative.flatten_white(bgra))
    np.testing.assert_array_equal(tio.flatten_white(bgra),
                                  jio.flatten_white(bgra))
    c = bgra[:, :, :3].astype(np.uint32)
    a = bgra[:, :, 3:4].astype(np.uint32)
    np.testing.assert_array_equal(
        got, ((c * a + 255 * (255 - a) + 127) // 255).astype(np.uint8))


@pytest.mark.parametrize("channels", [3, 4])
def test_io_png_bytes_equal_to_jax(tmp_path, rng, channels):
    im = rng.integers(0, 256, (21, 34, channels), np.uint8)
    p, q = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tio.imwrite_bgr(p, im)
    jio.imwrite_bgr(q, im)
    assert open(p, "rb").read() == open(q, "rb").read()
    np.testing.assert_array_equal(tio.imread_bgr(p), jio.imread_bgr(q))
    np.testing.assert_array_equal(tio.imread_bgra(p), jio.imread_bgra(q))


def test_io_jpeg_decode_equal_to_jax(tmp_path, rng):
    from PIL import Image
    im = rng.integers(0, 256, (24, 40, 3), np.uint8)
    p = str(tmp_path / "t.jpg")
    Image.fromarray(im).save(p, quality=90)
    got = tio.imread_bgr(p)
    np.testing.assert_array_equal(got, jio.imread_bgr(p))
    np.testing.assert_array_equal(got, tnative.imread(p))
    assert got.shape == (24, 40, 3)
    assert tio.imread_bgra(p) is None      # a JPEG has no alpha
    batch = tio.imread_batch_bgr([p, p], jobs=2)
    for b in batch:
        np.testing.assert_array_equal(b, got)


def test_io_batch_matches_single(tmp_path, rng):
    paths = []
    for i in range(5):
        p = str(tmp_path / f"f{i}.png")
        tio.imwrite_bgr(p, rng.integers(0, 256, (9, 7 + i, 3), np.uint8))
        paths.append(p)
    got = tio.imread_batch_bgr(paths, jobs=3)
    want = jio.imread_batch_bgr(paths, jobs=3)
    for g, w, p in zip(got, want, paths):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tio.imread_bgr(p))


def test_io_missing_file_raises(tmp_path):
    for fn in (tio.imread_bgr, tio.imread_bgra):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "nope.png"))


def test_io_falls_back_without_native(tmp_path, rng, monkeypatch):
    """With the native runtime unavailable, the chain goes on to cv2 or
    PIL and decodes the same pixels."""
    im = rng.integers(0, 256, (13, 15, 3), np.uint8)
    bgra = rng.integers(0, 256, (13, 15, 4), np.uint8)
    p, pa = str(tmp_path / "t.png"), str(tmp_path / "a.png")
    tio.imwrite_bgr(p, im)
    tio.imwrite_bgr(pa, bgra)
    monkeypatch.setattr(tnative, "load", lambda: None)
    np.testing.assert_array_equal(tio.imread_bgr(p), im)
    np.testing.assert_array_equal(tio.imread_bgra(pa), bgra)
    assert tio.imread_bgra(p) is None
    for b, want in zip(tio.imread_batch_bgr([p, pa]), (im, bgra[..., :3])):
        np.testing.assert_array_equal(b, want)
    q = str(tmp_path / "fallback.png")
    tio.imwrite_bgr(q, im)
    monkeypatch.undo()
    np.testing.assert_array_equal(tnative.imread(q), im)


@pytest.mark.parametrize(
    "path,mode,level,ratio,want",
    [
        ("/p/img.jpg", "noise_scale", 1, 2.0,
         "/p/img(noise_scale)(Level1)(x2.000000).png"),
        ("/p/img.jpg", "noise", 2, 2.0, "/p/img(noise)(Level2).png"),
        ("/p/img.jpg", "scale", 1, 2.5, "/p/img(scale)(x2.500000).png"),
        ("/p/a.b.c", "scale", 1, 1.6, "/p/a.b(scale)(x1.600000).png"),
        ("noext", "noise", 1, 2.0, "noext(noise)(Level1).png"),
    ],
)
def test_auto_output_name(path, mode, level, ratio, want):
    got = tio.auto_output_name(path, mode, level, ratio)
    assert got == want == jio.auto_output_name(path, mode, level, ratio)
    assert tio._cpp_double_str(ratio) == jio._cpp_double_str(ratio)


def test_default_model_dir(monkeypatch, tmp_path):
    assert tio.default_model_dir() == jio.default_model_dir() == os.path.join(
        ROOT, "models")
    # no models/ beside the package: the per-user cache, under the port's
    # own name
    monkeypatch.setattr(os.path, "isdir", lambda p: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tio.default_model_dir() == str(tmp_path / "waifu2x_torch" /
                                          "models")


@pytest.mark.parametrize("shape", [(5, 7, 12), (2, 4, 6, 4), (1, 3, 3, 16)])
def test_d2s_host_native_matches_numpy(rng, shape):
    src = rng.integers(0, 256, shape, np.uint8)
    got = ts2d.d2s_host(src)
    *n, h2, w2, c4 = shape
    ref = np.moveaxis(src.reshape(*n, h2, w2, 2, 2, c4 // 4), -3, -4)
    ref = ref.reshape(*n, 2 * h2, 2 * w2, c4 // 4)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jd2s_host(src))
    # f32 input keeps the numpy form
    f = src.astype(np.float32)
    np.testing.assert_array_equal(ts2d.d2s_host(f), ref.astype(np.float32))


def test_io_imports_without_pil_and_cv2(tmp_path, rng):
    """The card's machine has neither PIL nor cv2: the module imports and
    reads and writes PNGs through the native runtime alone."""
    im = rng.integers(0, 256, (6, 9, 3), np.uint8)
    src = str(tmp_path / "in.npy")
    np.save(src, im)
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from waifu2x_torch import io\n"
        f"im = np.load({src!r})\n"
        f"p = {str(tmp_path / 'out.png')!r}\n"
        "io.imwrite_bgr(p, im)\n"
        "assert np.array_equal(io.imread_bgr(p), im)\n"
        "assert np.array_equal(io.imread_batch_bgr([p, p])[1], im)\n"
        "assert sys.modules['PIL'] is None and sys.modules['cv2'] is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _no_codec_but_png(monkeypatch):
    monkeypatch.setattr(tnative, "load", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_io_png_only_without_any_library(tmp_path, rng, monkeypatch):
    """No native runtime, cv2 or PIL: PNGs go through pngcodec, and a JPEG
    fails with an error that says why."""
    from PIL import Image
    im = rng.integers(0, 256, (9, 14, 3), np.uint8)
    bgra = rng.integers(0, 256, (9, 14, 4), np.uint8)
    p, pa, pj = (str(tmp_path / n) for n in ("t.png", "a.png", "t.jpg"))
    tio.imwrite_bgr(p, im)
    tio.imwrite_bgr(pa, bgra)
    Image.fromarray(im).save(pj)
    _no_codec_but_png(monkeypatch)
    tio.CODEC_CALLS.clear()
    np.testing.assert_array_equal(tio.imread_bgr(p), im)
    np.testing.assert_array_equal(tio.imread_bgra(pa), bgra)
    np.testing.assert_array_equal(tio.imread_bgr(pa), bgra[..., :3])
    assert tio.imread_bgra(p) is None
    q = str(tmp_path / "out.png")
    tio.imwrite_bgr(q, bgra)
    assert tio.CODEC_CALLS == {("read", "png"): 4, ("write", "png"): 1}
    with pytest.raises(IOError, match="PNG only"):
        tio.imread_bgr(pj)
    with pytest.raises(IOError, match="PNG only"):
        tio.imwrite_bgr(str(tmp_path / "out.jpg"), im)
    monkeypatch.undo()
    np.testing.assert_array_equal(tnative.imread(q, keep_alpha=True), bgra)


def test_codec_calls_count_the_native_route(tmp_path, rng):
    paths = [str(tmp_path / f"f{i}.png") for i in range(3)]
    tio.CODEC_CALLS.clear()
    for p in paths:
        tio.imwrite_bgr(p, rng.integers(0, 256, (5, 6, 3), np.uint8))
    tio.imread_bgr(paths[0])
    tio.imread_batch_bgr(paths)
    assert tio.CODEC_CALLS == {("write", "native"): 3, ("read", "native"): 4}


def _filtered_image(rng, h=64, w=80, c=3):
    """An image on which libpng's adaptive filtering picks every one of the
    five row filters (checked in the test)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 3, y * 4, (x + y) * 2, x + 2 * y][:c], -1)
    img = (base + rng.integers(0, 3, (h, w, c))).astype(np.uint8)
    img[20:30] = rng.integers(0, 256, (10, w, c))
    img[40:50] = (np.sin(x[40:50] / 3)[..., None] * 100 + 120).astype(np.uint8)
    return img


@pytest.mark.parametrize("channels", [3, 4])
def test_pngcodec_decodes_libpng_files(tmp_path, rng, channels):
    """Files written by libpng (the native runtime), every row filter among
    them, decode to the native decoder's pixels."""
    import zlib
    img = _filtered_image(rng, c=channels)
    p = str(tmp_path / "f.png")
    assert tnative.imwrite_png(p, img)
    data = open(p, "rb").read()
    idat = b"".join(b for k, b in pngcodec._chunks(data) if k == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(64, -1)
    assert set(rows[:, 0]) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(pngcodec.read_bgr(p), tnative.imread(p))
    np.testing.assert_array_equal(pngcodec.read_bgr(p, keep_alpha=True),
                                  tnative.imread(p, keep_alpha=True))


@pytest.mark.parametrize("channels", [3, 4])
def test_pngcodec_roundtrip_through_native(tmp_path, rng, channels):
    img = rng.integers(0, 256, (23, 31, channels), np.uint8)
    p = str(tmp_path / "f.png")
    pngcodec.write_bgr(p, img)
    np.testing.assert_array_equal(tnative.imread(p, keep_alpha=True), img)
    np.testing.assert_array_equal(pngcodec.read_bgr(p, keep_alpha=True), img)
    np.testing.assert_array_equal(pngcodec.read_bgr(p), img[..., :3])


@pytest.mark.parametrize("mode", ["L", "LA"])
def test_pngcodec_gray(tmp_path, rng, mode):
    from PIL import Image
    n = 1 if mode == "L" else 2
    px = rng.integers(0, 256, (12, 17, n), np.uint8)
    p = str(tmp_path / "g.png")
    Image.fromarray(px[..., 0] if n == 1 else px, mode).save(p)
    np.testing.assert_array_equal(pngcodec.read_bgr(p), tnative.imread(p))
    np.testing.assert_array_equal(pngcodec.read_bgr(p, keep_alpha=True),
                                  tnative.imread(p, keep_alpha=True))


def test_pngcodec_rejects_what_it_does_not_read(tmp_path, rng):
    from PIL import Image
    import struct
    import zlib
    p16, pi, pp = (str(tmp_path / n) for n in ("16.png", "i.png", "p.png"))
    Image.fromarray(rng.integers(0, 65536, (5, 6), np.uint16)).save(p16)
    Image.fromarray(rng.integers(0, 256, (9, 9, 3), np.uint8)).convert(
        "P").save(pp)
    good = pngcodec.encode(rng.integers(0, 256, (4, 4, 3), np.uint8))
    # the same file with Adam7 interlacing declared in its header
    ihdr = good[12:28] + b"\x01"
    with open(pi, "wb") as f:
        f.write(good[:8] + good[8:12] + ihdr
                + struct.pack(">I", zlib.crc32(ihdr) & 0xFFFFFFFF)
                + good[33:])
    for path in (p16, pi, pp):
        with pytest.raises(ValueError, match="unsupported PNG"):
            pngcodec.read_bgr(path)
    with pytest.raises(ValueError, match="bad CRC"):
        pngcodec.decode(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        pngcodec.decode(b"GIF89a" + good[6:])
