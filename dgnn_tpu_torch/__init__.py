"""dgnn_tpu_torch — the PyTorch / NVIDIA Hopper port of dgnn_tpu.

Module names mirror ``dgnn_tpu`` so each port module sits beside its
counterpart: ``data`` (synthetic datasets), ``graph`` (host-side CSR/CSC
build, degree binning, hub planning, tensor containers), ``ops`` (the fused
GAT and MoNet aggregations and their hand-written CUDA kernels, the flat
primitives, the naive baselines, the dense oracles), ``native`` (the host
host graph build's C++ library, built by g++ at first use), ``models``
(GATConv / GAT and GMMConv / MoNet as ``nn.Module``s) and ``utils`` (CSV
rows, CUDA-event timing, the trainers' loss and optimizer, checkpoints,
profiling).

Importing the package loads no kernel: the CUDA library is built by
``ops/_build.py`` at the first launch on a CUDA tensor.
"""
