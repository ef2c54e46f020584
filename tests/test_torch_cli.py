"""The port's command line (waifu2x_torch.cli) against the JAX package's
(waifu2x_tpu.cli): the flag surface, the constraints, and end-to-end file
conversion on the CPU on seeded PNGs, at the u8 bar (|diff| <= 1 at < 0.2%
of bytes; 1% for the kernels' plain versions against the f32 path, the bar
of tests/test_torch_pipeline.py). Also the build cache (utils/cache.py)."""

import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from waifu2x_tpu import cli as jcli
from waifu2x_tpu import io as jio
from waifu2x_tpu.models import ModelSpec, init_params
from waifu2x_tpu.models.srcnn import as_numpy
from waifu2x_tpu.models.weights import save_model_json
from waifu2x_torch import cli as tcli
from waifu2x_torch import io as tio
from waifu2x_torch.ops import _build
from waifu2x_torch.utils.cache import enable_compilation_cache

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _build_dir(monkeypatch):
    """Every CLI run reads W2X_BUILD_DIR: keep the host's out of these tests
    and restore ops/_build.BUILD_DIR after each."""
    monkeypatch.delenv("W2X_BUILD_DIR", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


@pytest.fixture
def logs(caplog):
    """Records of the port's loggers (they do not propagate to the root)."""
    root = logging.getLogger("waifu2x_torch")
    root.addHandler(caplog.handler)
    yield caplog
    root.removeHandler(caplog.handler)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_equal_jax_except_device():
    """Every flag of the JAX CLI, the same; --device differs; the port's
    own --arch, --model_file and --model_seed (UpCUNet) are added, their
    defaults the 7-layer model's path."""
    got, want = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    own = {"arch", "model_file", "model_seed"}
    assert set(got) == set(want) | own and not own & set(want)
    assert got["arch"].default == "vgg7"
    assert got["arch"].choices == ["vgg7", "upcunet"]
    assert got["model_file"].default is got["model_seed"].default is None
    for dest, a in want.items():
        b = got[dest]
        fields = ("option_strings", "nargs", "const", "required", "type",
                  "metavar", "version")
        if dest != "device":
            fields += ("default", "choices")
        for f in fields:
            assert getattr(b, f, None) == getattr(a, f, None), (dest, f)
        assert type(b) is type(a), dest
    assert got["device"].default == "cuda"
    assert got["device"].choices == ["cuda", "cpu"]


def test_defaults_match_reference():
    args = tcli.build_parser().parse_args(["-i", "in.png"])
    cfg = tcli.config_from_args(args)
    jargs = jcli.build_parser().parse_args(["-i", "in.png"])
    jcfg = jcli.config_from_args(jargs)
    assert cfg.mode == "noise_scale"          # main.cpp:42
    assert cfg.noise_level == 1               # main.cpp:49
    assert cfg.scale_ratio == 2.0             # main.cpp:52
    assert cfg.jobs == 4                      # main.cpp:59
    assert args.output_file == "(auto)"       # main.cpp:34
    assert cfg.block_size == 512              # modelHandler.hpp:99
    for f in ("mode", "noise_level", "scale_ratio", "model_dir", "jobs",
              "block_size", "tile_size", "precision", "compute_dtype",
              "use_pallas", "mesh", "alpha", "batch_tiles"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for flag, cf in (("on", True), ("off", False), ("auto", "auto")):
        a = tcli.build_parser().parse_args(["-i", "x", "--pallas", flag])
        assert tcli.config_from_args(a).use_pallas == cf
    a = tcli.build_parser().parse_args(["-i", "x", "--pallas"])
    assert tcli.config_from_args(a).use_pallas is True


@pytest.mark.parametrize("argv", [
    ["-i", "x.png", "-m", "bogus"], ["-i", "x.png", "--noise_level", "3"],
    [], ["-i", "x.png", "--device", "tpu"], ["-i", "x.png", "--alpha", "x"]])
def test_constraints(argv):
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(argv)


def test_version(capsys):
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--version"])
    assert capsys.readouterr().out.strip() == "1.0.0"


def test_input_accumulates():
    p = tcli.build_parser()
    assert p.parse_args(["-i", "a", "b", "-i", "c"]).input_file == [
        "a", "b", "c"]
    assert p.parse_args(["-i", "a", "-i", "b"]).input_file == ["a", "b"]


def _write_models(model_dir, spec=ModelSpec.from_widths([1, 3, 1])):
    os.makedirs(model_dir, exist_ok=True)
    for name, seed in [("noise1_model.json", 0), ("noise2_model.json", 1),
                       ("scale2.0x_model.json", 2)]:
        save_model_json(os.path.join(model_dir, name),
                        as_numpy(init_params(jax.random.PRNGKey(seed), spec)))
    return model_dir


def _demo_models(model_dir):
    os.makedirs(model_dir, exist_ok=True)
    for name in ("noise1", "noise2", "scale2.0x"):
        shutil.copy(ROOT / "models" / f"{name}_demo.json",
                    os.path.join(model_dir, f"{name}_model.json"))
    return model_dir


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


def _both(tmp_path, rng, argv_of, shape=(20, 24, 3), n=1):
    """Write n seeded PNGs in0.png, in1.png, ... into two directories, run
    the JAX CLI in one and the port's in the other on argv_of(inputs) with
    --device cpu; returns the two directories (JAX's first)."""
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    dirs = []
    for side, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / side
        d.mkdir()
        paths = []
        for i, im in enumerate(imgs):
            paths.append(str(d / f"in{i}.png"))
            jio.imwrite_bgr(paths[-1], im)
        assert main(argv_of(paths) + ["--device", "cpu"]) == 0
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("mode,extra", [
    ("noise_scale", []), ("noise", ["--noise_level", "2"]),
    ("scale", ["--scale_ratio", "1.6"]), ("scale", ["--alpha", "bicubic"]),
    ("scale", ["--alpha", "flatten"]), ("noise_scale", ["--alpha", "flatten"]),
])
def test_end_to_end_matches_jax(tmp_path, rng, mode, extra):
    model_dir = _write_models(str(tmp_path / "models"))
    channels = 4 if "--alpha" in extra else 3
    jdir, tdir = _both(tmp_path, rng, lambda p: [
        "-i", *p, "-m", mode, "--model_dir", model_dir, *extra],
        shape=(20, 24, channels))
    out = tio.auto_output_name("in0.png", mode, int(
        extra[1]) if "--noise_level" in extra else 1, float(
        extra[1]) if "--scale_ratio" in extra else 2.0)
    read = tio.imread_bgra if "bicubic" in extra else tio.imread_bgr
    got, want = read(str(tdir / out)), read(str(jdir / out))
    assert got is not None and got.shape[2] == (
        4 if "bicubic" in extra else 3)
    _assert_u8_close(got, want)


def test_explicit_output(tmp_path, rng):
    model_dir = _write_models(str(tmp_path / "models"))
    jdir, tdir = _both(tmp_path, rng, lambda p: [
        "-i", p[0], "-o", str(Path(p[0]).parent / "o.png"), "-m", "noise",
        "--model_dir", model_dir], shape=(16, 16, 3))
    assert sorted(os.listdir(tdir)) == ["in0.png", "o.png"]
    _assert_u8_close(tio.imread_bgr(str(tdir / "o.png")),
                     tio.imread_bgr(str(jdir / "o.png")))


def test_several_inputs_match_jax(tmp_path, rng):
    model_dir = _write_models(str(tmp_path / "models"))
    jdir, tdir = _both(tmp_path, rng, lambda p: list(itertools.chain(
        *(("-i", x) for x in p))) + ["-m", "scale", "--model_dir", model_dir],
        shape=(12, 14, 3), n=3)
    for i in range(3):
        name = f"in{i}(scale)(x2.000000).png"
        got = tio.imread_bgr(str(tdir / name))
        assert got.shape == (24, 28, 3)
        _assert_u8_close(got, tio.imread_bgr(str(jdir / name)))


def test_flagship_kernel_route_matches_jax(tmp_path, rng):
    """--pallas on on the CPU (the kernels' plain versions, f32) against
    JAX's f32 non-kernel path, on the shipped weights."""
    model_dir = _demo_models(str(tmp_path / "models"))
    img = rng.integers(0, 256, (26, 22, 3), dtype=np.uint8)
    src = str(tmp_path / "in.png")
    tio.imwrite_bgr(src, img)
    t_out, j_out = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    common = ["-i", src, "-m", "scale", "--model_dir", model_dir,
              "--compute_dtype", "float32", "--device", "cpu"]
    assert tcli.main(common + ["-o", t_out, "--pallas", "on"]) == 0
    assert jcli.main(common + ["-o", j_out, "--pallas", "off"]) == 0
    _assert_u8_close(tio.imread_bgr(t_out), tio.imread_bgr(j_out), frac=0.01)


def test_refusals(tmp_path, rng, logs):
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    model_dir = _write_models(str(tmp_path / "models"))
    # -o with several inputs
    assert tcli.main(["-i", src, src, "-o", str(tmp_path / "x.png"),
                      "--model_dir", model_dir, "--device", "cpu"]) == 1
    # a missing model dir
    assert tcli.main(["-i", src, "--model_dir", str(tmp_path / "nope"),
                      "--device", "cpu"]) == 1
    # a missing input
    assert tcli.main(["-i", str(tmp_path / "none.png"), "--model_dir",
                      model_dir, "--device", "cpu"]) == 1
    assert sorted(os.listdir(tmp_path)) == ["a.png", "models"]


def test_no_card_without_device_cpu(tmp_path, rng, logs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    model_dir = _write_models(str(tmp_path / "models"))
    before = sorted(os.listdir(model_dir))
    assert tcli.main(["-i", src, "--model_dir", model_dir]) == 1
    assert sorted(os.listdir(tmp_path)) == ["a.png", "models"]
    assert sorted(os.listdir(model_dir)) == before
    assert any("--device cpu" in r.getMessage() for r in logs.records
               if r.levelno == logging.ERROR)


def test_mesh_runs_on_cpu_positions(tmp_path, rng, logs, monkeypatch):
    """--device cpu with an explicit mesh takes that many CPU positions for
    the run (as the JAX package's CLI asks XLA for that many host devices):
    --mesh 1x2 shards the conversion, writes the one-device run's file and
    warns of nothing; the CPU position count is restored after the run."""
    from waifu2x_torch.parallel import mesh as tmesh
    from waifu2x_torch.parallel import mesh_pipeline
    calls = []
    orig = mesh_pipeline.MeshPipeline.convert_bgr_u8

    def spy(self, bgr_u8):
        calls.append(self.mesh.shape)
        return orig(self, bgr_u8)

    monkeypatch.setattr(mesh_pipeline.MeshPipeline, "convert_bgr_u8", spy)
    model_dir = _demo_models(str(tmp_path / "models"))
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (16, 32, 3), dtype=np.uint8))
    outs = {}
    for mesh in ("1x2", "off"):
        out = str(tmp_path / f"a_{mesh}.png")
        assert tcli.main(["-i", src, "-o", out, "-m", "scale", "--model_dir",
                          model_dir, "--device", "cpu", "--pallas", "on",
                          "--mesh", mesh]) == 0
        outs[mesh] = tio.imread_bgr(out)
    assert calls == [(1, 1, 2)] and tmesh.CPU_DEVICES == 1
    assert outs["1x2"].shape == (32, 64, 3)
    np.testing.assert_array_equal(outs["1x2"], outs["off"])
    assert not any("mesh" in r.getMessage() for r in logs.records
                   if r.levelno >= logging.WARNING)


def test_profile_writes_a_trace(tmp_path, rng, logs):
    """The Chrome trace holds the program's spans, and the run record their
    sums by name."""
    model_dir = _write_models(str(tmp_path / "models"))
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    trace_dir = tmp_path / "trace"
    assert tcli.main(["-i", src, "-m", "scale", "--model_dir", model_dir,
                      "--device", "cpu", "--profile", str(trace_dir)]) == 0
    (trace,) = trace_dir.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert any(e.get("name") == "w2x.colour" for e in events)
    (run,) = [r.w2x_run for r in logs.records if hasattr(r, "w2x_run")]
    colour = run["spans"]["w2x.colour"]
    assert colour["count"] >= 2 and colour["host_s"] > 0
    assert colour["device_s"] is None
    assert not any(k.startswith("w2x.setup.") for k in run["spans"])


def test_run_record_splits_the_time(tmp_path, rng, logs):
    model_dir = _write_models(str(tmp_path / "models"))
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    tio.CODEC_CALLS.clear()
    assert tcli.main(["-i", src, "-m", "scale", "--model_dir", model_dir,
                      "--device", "cpu"]) == 0
    (run,) = [r.w2x_run for r in logs.records if hasattr(r, "w2x_run")]
    assert run["files"] == 1 and run["route"] == "per_image"
    assert run["mp"] == 16 * 16 / 1e6
    assert all(run[k] >= 0 for k in ("decode", "convert", "encode"))
    assert run["seconds"] >= run["decode"] + run["convert"] + run["encode"]
    assert "spans" not in run
    assert tio.CODEC_CALLS == {("read", "native"): 1, ("write", "native"): 1}


def _subprocess_cli(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_module_and_launcher(tmp_path, rng):
    """`python3 -m waifu2x_torch.cli -i x.png --device cpu` writes the
    auto-named output, equal to the JAX command's at the u8 bar; without
    --device cpu on a host with no card the launcher exits 1, names
    --device cpu and writes nothing."""
    model_dir = _demo_models(str(tmp_path / "models"))
    src = str(tmp_path / "x.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (24, 20, 3), dtype=np.uint8))
    out = tmp_path / "x(noise_scale)(Level1)(x2.000000).png"
    r = _subprocess_cli(["-m", "waifu2x_torch.cli", "-i", src, "--device",
                         "cpu", "--model_dir", model_dir], ROOT)
    assert r.returncode == 0, r.stderr
    got = tio.imread_bgr(str(out))
    os.remove(out)
    assert jcli.main(["-i", src, "--device", "cpu", "--model_dir",
                      model_dir]) == 0
    _assert_u8_close(got, tio.imread_bgr(str(out)))
    os.remove(out)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _subprocess_cli([str(ROOT / "bin" / "waifu2x-torch"), "-i", src,
                         "--model_dir", model_dir], tmp_path, env)
    assert r.returncode == 1 and "--device cpu" in r.stderr
    assert sorted(os.listdir(tmp_path)) == ["models", "x.png"]


def test_pyproject_names_the_console_script():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'waifu2x-torch = "waifu2x_torch.cli:main"' in text


# -- the build cache (utils/cache.py) ---------------------------------------

def test_build_dir_follows_argument_then_env(tmp_path, monkeypatch):
    default = _build.BUILD_DIR
    assert default == ROOT / "waifu2x_torch" / "build"
    enable_compilation_cache()
    assert _build.BUILD_DIR == default
    monkeypatch.setenv("W2X_BUILD_DIR", str(tmp_path / "env"))
    enable_compilation_cache()
    assert _build.BUILD_DIR == tmp_path / "env"
    enable_compilation_cache(str(tmp_path / "arg"))
    assert _build.BUILD_DIR == tmp_path / "arg"
    # the library names keep their source hash under any directory
    assert _build._lib_path("gather").parent == tmp_path / "arg"
    assert _build._lib_path("gather").name.startswith("libgather-")


def test_cli_reads_w2x_build_dir_and_builds_nothing_on_cpu(tmp_path, rng,
                                                           monkeypatch):
    monkeypatch.setenv("W2X_BUILD_DIR", str(tmp_path / "cache"))

    def no_build(*names):
        raise AssertionError(f"built {names} on the CPU")

    monkeypatch.setattr(_build, "load", no_build)
    model_dir = _demo_models(str(tmp_path / "models"))
    src = str(tmp_path / "a.png")
    tio.imwrite_bgr(src, rng.integers(0, 256, (10, 12, 3), dtype=np.uint8))
    assert tcli.main(["-i", src, "--model_dir", model_dir, "--device", "cpu",
                      "--pallas", "on"]) == 0
    assert _build.BUILD_DIR == tmp_path / "cache"
    assert not (tmp_path / "cache").exists()


def test_imports_start_no_compiler(tmp_path):
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError(f'subprocess at import: {a}')\n"
        "subprocess.Popen = boom\n"
        "subprocess.run = boom\n"
        "import waifu2x_torch.cli, waifu2x_torch.utils.cache\n"
        "import waifu2x_torch.stream, waifu2x_torch.pipeline\n"
        "import waifu2x_torch.parallel.tiles, waifu2x_torch.train.checkpoint\n"
        "from waifu2x_torch.ops import _build\n"
        "from waifu2x_torch.utils.cache import enable_compilation_cache\n"
        f"enable_compilation_cache({str(tmp_path / 'c')!r})\n"
        "assert not _build._libs\n"
        "print('ok')\n")
    r = _subprocess_cli(["-c", code], ROOT)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert not (tmp_path / "c").exists()
