from waifu2x_torch.models.srcnn import (  # noqa: F401
    SRCNN,
    LayerSpec,
    ModelSpec,
    WAIFU2X_7LAYER,
    count_maccs_per_pixel,
    init_params,
    validate_params,
)
from waifu2x_torch.models.weights import (  # noqa: F401
    load_model_json,
    model_file_for,
    params_from_json_obj,
    params_from_numpy,
    params_to_json_obj,
    save_model_json,
)
