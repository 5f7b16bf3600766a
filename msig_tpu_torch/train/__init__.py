"""Training runtime of the port: step, schedules, state, trainer loop, checkpoints."""

from msig_tpu_torch.train.schedule import (  # noqa: F401
    WEIGHT_KEYS,
    cosine_lr,
    current_loss_weights,
    loss_weight_factor,
    weights_vector,
)
from msig_tpu_torch.train.state import (  # noqa: F401
    AdamState,
    Models,
    TrainState,
    create_train_state,
)
from msig_tpu_torch.train.step import make_train_step, prepare_images  # noqa: F401
