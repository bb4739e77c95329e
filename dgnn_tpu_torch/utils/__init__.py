from .logging import append_csv_row
from .timing import peak_memory_mb, reset_peak_memory, time_calls

__all__ = ["append_csv_row", "peak_memory_mb", "reset_peak_memory",
           "time_calls"]
