from .logging import append_csv_row
from .timing import peak_memory_mb, reset_peak_memory, time_calls
from .training import make_optimizer, masked_loss

__all__ = ["append_csv_row", "make_optimizer", "masked_loss",
           "peak_memory_mb", "reset_peak_memory", "time_calls"]
