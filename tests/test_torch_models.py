"""The port's model layer (waifu2x_torch.models) against the JAX package's:
weight files load to identical arrays, the JSON round trip holds,
parameters carry across unchanged, and validation rejects the same shapes
with the same messages."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from waifu2x_tpu.models import srcnn as jsrcnn
from waifu2x_tpu.models import weights as jweights
from waifu2x_tpu.models import zoo as jzoo
from waifu2x_torch.models import srcnn, weights, zoo
from waifu2x_torch.ops.convstack import convert_plane

torch.set_num_threads(2)

MODELS = sorted((Path(__file__).resolve().parents[1] / "models")
                .glob("*_demo.json"))


def _jax_params(seed, spec=jsrcnn.WAIFU2X_7LAYER):
    return jsrcnn.as_numpy(jsrcnn.init_params(jax.random.PRNGKey(seed), spec))


def _assert_params_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p["w"].dtype == torch.float32 and p["b"].dtype == torch.float32
        np.testing.assert_array_equal(p["w"].numpy(), np.asarray(r["w"]))
        np.testing.assert_array_equal(p["b"].numpy(), np.asarray(r["b"]))


@pytest.mark.parametrize("path", MODELS, ids=lambda p: p.name)
def test_demo_weights_load_bit_identical(path):
    _assert_params_equal(weights.load_model_json(path),
                         jweights.load_model_json(path))


def test_json_round_trip(tmp_path):
    params = weights.params_from_numpy(_jax_params(5))
    weights.save_model_json(tmp_path / "m.json", params)
    _assert_params_equal(weights.load_model_json(tmp_path / "m.json"), params)
    # the port's file is the reference schema: the JAX loader reads it too
    _assert_params_equal(params, jweights.load_model_json(tmp_path / "m.json"))
    assert weights.params_to_json_obj(params) == \
        jweights.params_to_json_obj(_jax_params(5))


def test_params_from_numpy_identical():
    ref = _jax_params(7)
    _assert_params_equal(weights.params_from_numpy(ref), ref)


def test_spec_and_counts_match():
    assert srcnn.WAIFU2X_7LAYER.offset == jsrcnn.WAIFU2X_7LAYER.offset == 7
    assert srcnn.count_maccs_per_pixel() == jsrcnn.count_maccs_per_pixel() \
        == 287_136
    params = srcnn.init_params(0)
    assert srcnn.validate_params(params) == srcnn.WAIFU2X_7LAYER
    assert params[0]["w"].std() > 0 and not params[0]["b"].any()


def _bad_param_sets():
    good = _jax_params(1, jsrcnn.ModelSpec.from_widths([1, 4, 1]))
    w0, b0, w1, b1 = good[0]["w"], good[0]["b"], good[1]["w"], good[1]["b"]
    z = np.zeros
    return {
        "empty": [],
        "ndim": [{"w": w0[0], "b": b0}, {"w": w1, "b": b1}],
        "non_square": [{"w": z((3, 5, 1, 4)), "b": b0}, {"w": w1, "b": b1}],
        "even_kernel": [{"w": z((2, 2, 1, 4)), "b": b0}, {"w": w1, "b": b1}],
        "bias": [{"w": w0, "b": z(3)}, {"w": w1, "b": b1}],
        "chain": [{"w": w0, "b": b0}, {"w": z((3, 3, 5, 1)), "b": b1}],
        "first_cin": [{"w": z((3, 3, 2, 4)), "b": b0}, {"w": w1, "b": b1}],
        "last_cout": [{"w": w0, "b": b0}, {"w": z((3, 3, 4, 2)), "b": z(2)}],
    }


@pytest.mark.parametrize("case", sorted(_bad_param_sets()))
def test_validate_params_rejects_like_jax(case):
    bad = _bad_param_sets()[case]
    with pytest.raises(ValueError) as ref:
        jsrcnn.validate_params(bad)
    with pytest.raises(ValueError) as got:
        srcnn.validate_params(weights.params_from_numpy(bad))
    assert str(got.value) == str(ref.value)


def test_validate_params_spec_mismatch():
    params = weights.params_from_numpy(_jax_params(2))
    with pytest.raises(ValueError, match="do not match spec"):
        srcnn.validate_params(params,
                              srcnn.ModelSpec.from_widths([1, 8, 1]))


def test_srcnn_module_matches_convert_plane():
    params = weights.params_from_numpy(_jax_params(4))
    model = srcnn.SRCNN.from_params(params)
    y = torch.from_numpy(np.random.default_rng(0).random((2, 12, 15),
                                                        dtype=np.float32))
    torch.testing.assert_close(model.convert_plane(y),
                               convert_plane(y, params), rtol=0, atol=0)
    assert not any(p.requires_grad for p in model.parameters())


def test_zoo_identity_and_defaults(tmp_path):
    for spec in (srcnn.WAIFU2X_7LAYER, srcnn.ModelSpec.from_widths([1, 4, 1])):
        jspec = jsrcnn.ModelSpec.from_widths(
            [l.cin for l in spec.layers] + [1])
        _assert_params_equal(zoo.identity_params(spec),
                             jzoo.identity_params(jspec))
    written = zoo.ensure_default_models(str(tmp_path))
    assert sorted(Path(p).name for p in written) == \
        sorted(zoo.DEFAULT_MODEL_NAMES)
    assert zoo.ensure_default_models(str(tmp_path)) == []
    _assert_params_equal(
        weights.load_model_json(weights.model_file_for(str(tmp_path), False)),
        jzoo.identity_params())
