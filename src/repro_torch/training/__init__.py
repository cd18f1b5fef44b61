from .optimizer import OptState, adamw_step, global_norm, init_opt_state, lr_schedule

__all__ = ["OptState", "adamw_step", "global_norm", "init_opt_state", "lr_schedule"]
from .loop import SimulatedFailure, Trainer, TrainReport

__all__ += ["SimulatedFailure", "Trainer", "TrainReport"]
