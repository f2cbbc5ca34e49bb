from .checkpoint import TrainCheckpointer  # noqa: F401
from .trainer import (  # noqa: F401
    TrainBatch,
    TrainConfig,
    flow_match_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
    sample_timesteps,
)
