from .logging import append_csv_row
from .timing import peak_memory_mb, reset_peak_memory, time_calls
from .training import (cosine_lr, make_optimizer, make_sgd_cosine,
                       masked_loss, smoothed_loss)

__all__ = ["append_csv_row", "cosine_lr", "make_optimizer", "make_sgd_cosine",
           "masked_loss", "peak_memory_mb", "reset_peak_memory",
           "smoothed_loss", "time_calls"]
