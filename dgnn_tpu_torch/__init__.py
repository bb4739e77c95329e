"""dgnn_tpu_torch — the PyTorch / NVIDIA Hopper port of dgnn_tpu.

Module names mirror ``dgnn_tpu`` so each port module sits beside its
counterpart: ``data`` (synthetic datasets), ``graph`` (host-side CSR/CSC
build, degree binning, hub planning, tensor containers), ``ops`` (the fused
GAT aggregation and its hand-written CUDA kernels), ``models`` (GATConv /
GAT as ``nn.Module``s) and ``utils`` (CSV rows, CUDA-event timing).

Importing the package loads no kernel: the CUDA library is built by
``ops/_build.py`` at the first launch on a CUDA tensor.
"""
