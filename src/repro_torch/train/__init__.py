from repro_torch.train.step import (AUX_WEIGHT, TrainState, loss_fn,
                                    make_train_step, train_init)

__all__ = ["AUX_WEIGHT", "TrainState", "loss_fn", "make_train_step",
           "train_init"]
