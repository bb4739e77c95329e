from .checkpoint import CheckpointManager
from .logging import append_csv_row
from .profiling import span, trace
from .timing import (StepGraph, device_peak_memory_mb, fetch_scalar,
                     reset_peak_memory, run_epochs, time_calls,
                     time_epoch_loop)
from .training import (SGDCosine, cosine_lr, make_optimizer,
                       make_sgd_cosine, masked_loss, smoothed_loss)

__all__ = ["CheckpointManager", "SGDCosine", "StepGraph", "append_csv_row",
           "cosine_lr", "device_peak_memory_mb", "fetch_scalar",
           "make_optimizer", "make_sgd_cosine", "masked_loss",
           "reset_peak_memory", "run_epochs", "smoothed_loss", "span",
           "time_calls", "time_epoch_loop", "trace"]
