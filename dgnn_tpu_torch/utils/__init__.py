from .checkpoint import CheckpointManager
from .logging import append_csv_row
from .profiling import (Roofline, gat_epoch_hbm_bytes, gat_epoch_row_accesses,
                        trace)
from .timing import peak_memory_mb, reset_peak_memory, time_calls
from .training import (cosine_lr, make_optimizer, make_sgd_cosine,
                       masked_loss, smoothed_loss)

__all__ = ["CheckpointManager", "Roofline", "append_csv_row", "cosine_lr",
           "gat_epoch_hbm_bytes", "gat_epoch_row_accesses", "make_optimizer",
           "make_sgd_cosine", "masked_loss", "peak_memory_mb",
           "reset_peak_memory", "smoothed_loss", "time_calls", "trace"]
