from .checkpoint import CheckpointManager
from .logging import append_csv_row
from .profiling import (Roofline, gat_epoch_hbm_bytes, gat_epoch_row_accesses,
                        trace)
from .timing import (StepGraph, Timer, device_peak_memory_mb, fetch_scalar,
                     reset_peak_memory, run_epochs, time_calls,
                     time_epoch_loop, time_fn, time_op)
from .training import (SGDCosine, cosine_lr, make_optimizer,
                       make_sgd_cosine, masked_loss, smoothed_loss)

__all__ = ["CheckpointManager", "Roofline", "SGDCosine", "StepGraph", "Timer",
           "append_csv_row", "cosine_lr", "device_peak_memory_mb",
           "fetch_scalar", "gat_epoch_hbm_bytes", "gat_epoch_row_accesses",
           "make_optimizer", "make_sgd_cosine", "masked_loss",
           "reset_peak_memory", "run_epochs", "smoothed_loss", "time_calls",
           "time_epoch_loop", "time_fn", "time_op", "trace"]
