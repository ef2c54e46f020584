"""Reference-compatible JSON weight format: load / save.

The on-disk schema is the reference's picojson model format (produced by
appendix/waifu2x-nocuda/export_model_nocuda.lua:9-24, consumed by
modelHandler.cpp:74-115):

    [                                    # one object per conv layer
      {
        "nInputPlane":  int,
        "nOutputPlane": int,
        "kW": int, "kH": int,
        "weight": [nOut][nIn][kH][kW] of float,
        "bias":   [nOut] of float
      },
      ...
    ]

In memory the port keeps the JAX package's HWIO layout ({"w": [kh,kw,cin,cout],
"b": [cout]}, f32 torch tensors on the CPU); the transpose is
[out][in][kh][kw] -> [kh][kw][in][out]. The stored kernels are applied as
2-D correlation (no flip), which is `F.conv2d`'s semantics.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from waifu2x_torch.models.srcnn import ModelSpec, validate_params


def params_from_numpy(params):
    """Carry parameters across from the JAX package: a sequence of
    {"w": HWIO, "b": [cout]} numpy (or array-like) layers -> the port's
    tuple of f32 CPU tensors, values unchanged."""
    return tuple({"w": torch.from_numpy(np.array(p["w"], np.float32)),
                  "b": torch.from_numpy(np.array(p["b"], np.float32))}
                 for p in params)


def params_from_json_obj(layers_json: list[dict[str, Any]]):
    """Convert a parsed reference-format JSON document to HWIO tensors."""
    params = []
    for i, layer in enumerate(layers_json):
        n_in = int(layer["nInputPlane"])
        n_out = int(layer["nOutputPlane"])
        kw = int(layer.get("kW", 3))
        kh = int(layer.get("kH", kw))
        if kw != kh:
            # mirrors the reference's hard requirement (modelHandler.hpp:56-59)
            raise ValueError(f"layer {i}: kW({kw}) != kH({kh}) is unsupported")
        w_oihw = np.asarray(layer["weight"], dtype=np.float32)
        if w_oihw.shape != (n_out, n_in, kh, kw):
            raise ValueError(f"layer {i}: weight shape {w_oihw.shape} != "
                             f"({n_out},{n_in},{kh},{kw})")
        b = np.asarray(layer["bias"], dtype=np.float32)
        if b.shape != (n_out,):
            raise ValueError(f"layer {i}: bias shape {b.shape} != ({n_out},)")
        params.append({"w": np.transpose(w_oihw, (2, 3, 1, 0)), "b": b})
    return params_from_numpy(params)


def params_to_json_obj(params) -> list[dict[str, Any]]:
    """Inverse of params_from_json_obj; emits the reference schema so model
    files written by the port load in the C++ converter unchanged."""
    layers_json = []
    for p in params:
        w = np.asarray(p["w"], np.float32)
        b = np.asarray(p["b"], np.float32)
        kh, kw, cin, cout = w.shape
        layers_json.append({
            "nInputPlane": int(cin),
            "nOutputPlane": int(cout),
            "kW": int(kw),
            "kH": int(kh),
            # HWIO -> OIHW, nested lists of Python floats
            "weight": np.transpose(w, (3, 2, 0, 1)).tolist(),
            "bias": b.tolist(),
        })
    return layers_json


def load_model_json(path: str | os.PathLike, spec: ModelSpec | None = None):
    """Load a reference-format model file -> validated HWIO tensors
    (modelUtility::generateModelFromJSON, modelHandler.cpp:170-197)."""
    with open(path, "r") as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise ValueError(f"{path}: model JSON must be an array of layers")
    params = params_from_json_obj(doc)
    validate_params(params, spec)
    return params


def save_model_json(path: str | os.PathLike, params) -> None:
    validate_params(params)
    with open(path, "w") as f:
        json.dump(params_to_json_obj(params), f)


def model_file_for(model_dir: str, mode_is_noise: bool,
                   noise_level: int = 1) -> str:
    """Model-file naming convention: <model_dir>/noise<level>_model.json or
    <model_dir>/scale2.0x_model.json (reference main.cpp:83-85, 116-117)."""
    if mode_is_noise:
        return os.path.join(model_dir, f"noise{noise_level}_model.json")
    return os.path.join(model_dir, "scale2.0x_model.json")
