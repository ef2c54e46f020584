from waifu2x_torch.utils.logging import get_logger  # noqa: F401
from waifu2x_torch.utils.metrics import (  # noqa: F401
    megapixels,
    psnr,
)
