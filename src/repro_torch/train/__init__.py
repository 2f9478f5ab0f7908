"""The training path: optimizers and the microbatched train step."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamState,
    FactorState,
    Optimizer,
    adafactor,
    adamw,
    get_optimizer,
    sgd,
)
from repro_torch.train.trainer import (  # noqa: F401
    make_eval_step,
    make_train_step,
)
