from .draft_trainer import (
    TrainState,
    causal_lm_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
    train_forward,
)
