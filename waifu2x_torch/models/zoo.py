"""Built-in model management.

The reference names three model files — noise1_model.json,
noise2_model.json, scale2.0x_model.json (main.cpp:83-85, 116-117). The repo
ships trained weights as models/*_demo.json; `ensure_default_models`
materialises the reference names from them, or writes deterministic
*identity* models in the same schema where no demo exists (each layer
routes plane 0 through its center tap: an exact no-op on non-negative luma,
since LeakyReLU is identity for x >= 0).
"""

from __future__ import annotations

import os
import shutil

import torch

from waifu2x_torch.models.srcnn import ModelSpec, WAIFU2X_7LAYER
from waifu2x_torch.models.weights import save_model_json

DEFAULT_MODEL_NAMES = (
    "noise1_model.json",
    "noise2_model.json",
    "scale2.0x_model.json",
)


def identity_params(spec: ModelSpec = WAIFU2X_7LAYER):
    """An exact-identity conv stack in the given architecture."""
    params = []
    for layer in spec.layers:
        w = torch.zeros((layer.ksize, layer.ksize, layer.cin, layer.cout))
        c = layer.ksize // 2
        w[c, c, 0, 0] = 1.0  # pass plane 0 through the center tap
        params.append({"w": w, "b": torch.zeros((layer.cout,))})
    return tuple(params)


def ensure_default_models(model_dir: str,
                          spec: ModelSpec = WAIFU2X_7LAYER) -> list[str]:
    """Materialise missing or STALE reference model files: prefer the
    shipped demo weights (models/*_demo.json), fall back to identity
    models. A *_model.json copied from a demo is refreshed when the demo is
    newer; a user's own *_model.json (no demo sibling) is never touched.
    Returns the list of files written."""
    os.makedirs(model_dir, exist_ok=True)
    written = []
    params = None
    for name in DEFAULT_MODEL_NAMES:
        path = os.path.join(model_dir, name)
        demo = os.path.join(model_dir, name.replace("_model.json",
                                                    "_demo.json"))
        has_demo = os.path.exists(demo)
        if os.path.exists(path):
            if not (has_demo
                    and os.path.getmtime(demo) > os.path.getmtime(path)):
                continue
        if has_demo:
            # copy2 keeps the demo's mtime, so the refresh is idempotent
            shutil.copy2(demo, path)
        else:
            if params is None:
                params = identity_params(spec)
            save_model_json(path, params)
        written.append(path)
    return written
