"""Training substrate of the port (``repro.training``'s counterpart):
AdamW with accumulation, checkpoints in the reference's format, the
deterministic data pipeline, int8 gradient compression."""
from repro_torch.training.checkpoint import latest_step, load, save  # noqa: F401
from repro_torch.training.data import (DataConfig, batch_at_step,  # noqa: F401
                                       data_iterator)
from repro_torch.training.optimizer import (AdamWConfig, OptState,  # noqa: F401
                                            apply_adamw, init_opt_state)
from repro_torch.training.train_step import (TrainConfig,  # noqa: F401
                                             init_train_state,
                                             loss_and_grads, make_train_step)
