from repro_torch.train.loss import lm_loss
from repro_torch.train.step import make_train_step, make_eval_step, init_train_state

__all__ = ["lm_loss", "make_train_step", "make_eval_step", "init_train_state"]
