"""Training (the counterpart of the JAX package's train/): pair generation
(data.py), the Adam loop with its schedules, clipping, EMA and sharded step
(train.py), the int8 layer-6 QAT loss (qat.py), and checkpoints and the
stream's frame cursor in the JAX package's formats (checkpoint.py)."""

from waifu2x_torch.train.train import (  # noqa: F401
    TrainConfig,
    loss_fn,
    make_train_step,
    make_sharded_train_step,
    train_loop,
)
from waifu2x_torch.train.qat import (  # noqa: F401
    l6_quant_gap_db,
    make_qat_l6_loss,
    stack_valid_l6fq,
)
