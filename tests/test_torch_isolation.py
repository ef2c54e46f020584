"""waifu2x_torch and chip_smoke.py import neither JAX (nor optax) nor the JAX
package.

An AST scan of the sources: the test process itself has JAX loaded (the
test suite and the host environment import it), so sys.modules cannot
show what the port imports."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "waifu2x_tpu")
SOURCES = sorted((ROOT / "waifu2x_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"waifu2x_torch/pipeline.py", "waifu2x_torch/ops/stack.py",
            "waifu2x_torch/ops/s2d.py", "waifu2x_torch/stream.py",
            "waifu2x_torch/train/__init__.py", "waifu2x_torch/train/qat.py",
            "waifu2x_torch/tools/__init__.py",
            "waifu2x_torch/tools/layer_time_probe.py",
            "waifu2x_torch/tools/i8_fidelity_probe.py",
            "waifu2x_torch/ops/probe.py",
            "waifu2x_torch/tools/stage_time.py",
            "waifu2x_torch/tools/grid_floor_probe.py",
            "waifu2x_torch/tools/dma_probe.py",
            "waifu2x_torch/tools/fused_strip_probe.py",
            "waifu2x_torch/tools/k1_forensics.py",
            "waifu2x_torch/tools/l14_probe.py",
            "waifu2x_torch/tools/tmm_probe.py",
            "waifu2x_torch/tools/accpp_probe.py",
            "waifu2x_torch/tools/l4_shift_probe.py",
            "waifu2x_torch/tools/shift_cost_probe.py",
            "waifu2x_torch/utils/timing.py",
            "waifu2x_torch/cli.py", "waifu2x_torch/io.py",
            "waifu2x_torch/native.py", "waifu2x_torch/pngcodec.py",
            "waifu2x_torch/parallel/tiles.py",
            "waifu2x_torch/parallel/mesh.py",
            "waifu2x_torch/parallel/sharded.py",
            "waifu2x_torch/parallel/fast_sharded.py",
            "waifu2x_torch/parallel/mesh_pipeline.py",
            "waifu2x_torch/parallel/multihost.py",
            "waifu2x_torch/tools/bench_sharded.py",
            "waifu2x_torch/tools/scaling_probe.py",
            "waifu2x_torch/tools/multiproc_worker.py",
            "waifu2x_torch/utils/cache.py",
            "waifu2x_torch/train/checkpoint.py",
            "waifu2x_torch/train/data.py", "waifu2x_torch/train/train.py",
            "waifu2x_torch/tools/train_demo.py",
            "waifu2x_torch/tools/chain_fidelity_probe.py",
            "waifu2x_torch/tools/edge_error_probe.py",
            "waifu2x_torch/tools/ns1080_probe.py",
            "chip_smoke.py"} <= names
    assert (ROOT / "waifu2x_torch" / "csrc" / "probe.cu").is_file()
    assert (ROOT / "waifu2x_torch" / "csrc" / "tmm.cu").is_file()
    # the Python callers of l1.cu, mma_tf32.cu and i8.cu are in ops/stack.py,
    # above
    assert (ROOT / "waifu2x_torch" / "csrc" / "l1.cu").is_file()
    assert (ROOT / "waifu2x_torch" / "csrc" / "mma_tf32.cu").is_file()
    assert (ROOT / "waifu2x_torch" / "csrc" / "i8.cu").is_file()


def test_stream_module_imports_only_the_port():
    """waifu2x_torch.stream reaches the rest of the system through the
    port's own modules: every import of a waifu2x package names
    waifu2x_torch."""
    mods = list(_imported_modules(ROOT / "waifu2x_torch" / "stream.py"))
    assert "torch" in mods
    ours = [m for m in mods if m.startswith("waifu2x")]
    assert ours and all(m.split(".")[0] == "waifu2x_torch" for m in ours)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
