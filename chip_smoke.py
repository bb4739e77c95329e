#!/usr/bin/env python3
"""Drive the PyTorch port (dgnn_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failure raises; nothing is caught and continued):

  1. device  - requires a CUDA device; prints nvidia-smi's name and power
               limit; turns TF32 off for matmuls and cuDNN.
  2. build   - builds the CUDA kernels from csrc/ (one nvcc per source, in
               parallel, sm_90a) and loads them; prints the build seconds and
               ptxas' register report.  Builds the native graph library
               (native/graph_prep.cc, g++) that the host graph build
               calls, and prints its seconds and path.
  3. kernels - bin kernels: every bin of synthetic pubmed's forward and
               backward graphs, at (H, F) = (4, 64) and (1, 3), attention
               dropout p 0 and 0.3, with and without the sign-split
               partials, plus a power-law graph with a bin wider than 64 and
               an empty segment in each direction (forward rtol 1e-5 / atol
               1e-5; backward rtol 1e-4 / atol 1e-5, the summation order
               differs).  All four bin kernels also in their list form,
               every bin of the direction in one launch (the form the ops
               call), on every graph checked (atol at least 8 W 2^-23 for
               the widest bin's W).  The four again with their feature
               rows in bf16 (the instances gather_dtype bfloat16 runs) on
               pubmed and the power-law graph, at the same tolerances: both
               sides widen the same bf16 values exactly, so only float32
               summation order tells them apart.
               Dense kernels: the hub blocks of cora and citeseer (the
               planner's, both directions) and a forced (1000, 5000) block
               of pubmed (4 row chunks x 3 column tiles, padded rows and
               columns), at (H, F) = (4, 64) and (1, 7), p 0 and 0.3, with
               and without the sign-split partials, dense_dtype float32 and
               bfloat16 (BLOCK_TOL; bf16 also BF16_FLIPS).  Each kernel is
               held against its plain PyTorch version on the card.  One
               flipped dropout bit would give an O(1) difference, so this
               also holds the dropout hash.  The bins that these three
               graphs keep beside their blocks go through the bin kernels
               too, at the same shapes.  And a forced (512, 3000) block of
               a graph skewed both ways (2 x 2 tiles, rows of about 1,700
               edges in each direction: the kernels' row lists in many
               batches), atol grown with the widest row.
               MoNet kernels, the same graphs (the skewed block too): the
               bin kernels at (K, F) = (3, 64) and (3, 3), the dense kernels
               at (3, 64) and (3, 7)
               in both dense dtypes, D = 2, tanh on and off (same
               tolerances; the backward's stat rows are held per segment
               and per block row to BWD_TOL / BLOCK_TOL), and the bin
               kernels on the hub graphs' bins at (3, 64) and (3, 7).
               EdgeConv: masked_max in both schedules ("step1", "step8"),
               with and without the first-winner index, at DGCNN's four
               layer shapes (B = 8, P = 1024, k = 40, a real knn_mask_neg
               mask in bfloat16), on the study's float32 / -1e9 mask at
               F = 256, at P = 1000, F = 70 (no multiple of any tile) with
               a row that admits nothing and a duplicated source row, and
               on the masks that make the kernels' list pass walk rows
               densely or keep columns a {0, neg} mask would drop (all
               zero, any floats in both dtypes, neg = -1 beside h_src of
               scale 10, a row one over the list's cap beside one at it):
               the max is exact, so tolerance 0 and the index equal; the
               list pass alone (live_counts) must count exactly the
               columns its plain rule (live_candidates) keeps.
               tie_sum_bwd (the tie-sum backward, csrc/ec_ties.cu: its
               list pass, then the sum) against its plain version
               _dsrc_ties on CPU copies of the same inputs (m from the
               card's masked max): the model's k-NN masks at B = 4,
               P = 1024, k = 40, F = 64, 128 and 256 with a duplicated
               source row every row admits (exact ties; columns past the
               lists' cap, walked densely); the masks a {0, neg} rule
               would get wrong at B = 2, P = 300, F = 70 (three values,
               {0, -8} beside h_src of scale 4, rows that admit nothing,
               any floats); a row one over the masked-max lists' cap; a
               k-NN mask at P = 1101, past the sum's 1024-row chunk, with
               a column every row admits and passes; each in both
               mul_dtypes, max |diff| 0 (every case sums the same pairs in
               the same order); two calls on the same inputs equal bit for
               bit, one list pass and one sum a call; the list pass alone
               (counts, and each list's entries) equal to its plain
               version tie_lists_plain.
               gather_rows_sum at W in {32, 64, 256} x rows of 4 KB and 1 KB
               and on large tables in many column slices of 32 floats
               (5200 floats a row, the last slice 16; 128; 36, the last
               slice one 16-byte group) (rtol 1e-5, atol 8 W 2^-23:
               sums of W terms in another order), and gather_lanes at
               tables of 512 ... 4096 rows, and at lane counts and widths
               that are no multiple of 4 or of the slab (exact).
  4. op      - gat_aggregate forward and (ar, ac, feat) gradients on the
               card against the same op on CPU copies (the plain path):
               pubmed at p 0 and 0.3; cora (hub block) at p 0 and 0.3 in
               both dense dtypes.  gmm_aggregate_node forward and the
               gradients of feat, proj_weight, proj_bias, mu and inv_sigma
               the same way: pubmed; cora in both dense dtypes.  The
               parameter gradients are sums of signed terms over every
               edge, so they get PARAM_TOL, scaled to the edge count.
               edge_conv_max_dense forward and (h_src, h_dst) gradients the
               same way at B = 2, P = 256, F = 96, one mask built once and
               copied: both backward modes (tie_sum through tie_sum_bwd's
               kernel), mul_dtype float32 (rtol 1e-5, atol 1e-6) and
               bfloat16 (rtol 5e-3, atol 2e-2).
  5. train   - the trainers at the bench widths, 20 steps and an eval each,
               on cora (bin and dense kernels) and on pubmed (bin kernels),
               through the JAX trainers' protocol (utils/timing.py: the
               training and the inference timed by time_epoch_loop, a
               CUDA graph of the step captured and replayed, training on a
               throwaway copy; then exactly 20 run_epochs replays from the
               initial state):
               scripts/train_gat_torch.py with heads (4, 1), hidden 64,
               feat_drop 0.5, attn_drop 0.3, Adam lr 1e-3, weight decay
               5e-4; scripts/train_gmm_torch.py with hidden 64, 3 kernels,
               pseudo dim 2, dropout 0.5, Adam lr 1e-2, weight decay 5e-4.
               The loss must be finite and fall; the launch counts must be
               exactly what the steps, evals, layers, bins and hub blocks
               imply (each bin kernel one launch a call over every bin of
               the direction; the steps and forwards counted on the card by
               the trainer, a replay's launches counted as its step's), and
               the other model's kernels must not launch; the
               trained model's logits on the card must match a CPU copy's;
               test accuracy must clear a margin above chance.
     loop    - after each of those four runs, on its graph and a copy of
               its model: LOOP_STEPS = 20 steps of the trainer's own step
               (make_step) issued from the host against 20 run_epochs
               replays from the same state and generator states; the
               losses and every parameter within LOOP_TOL (rtol 1e-5, atol
               1e-6 of each tensor's largest element; bit-equality
               printed), GAT's attention seeds (logged on the card) the
               same on both sides and different from each step to the
               next, the launches exactly 2 x 20 steps'; then eager against
               replayed ms a step, 50 steps each.  The GAT kernels read
               the seed from device memory throughout: the kernels phase
               holds them (and their bf16 and gid instances) to their
               plain versions with the seed an int64 or int32 on the card.
               MoNet again on pubmed at the CLI's default, binned per-edge
               pseudo with no hub block (plain PyTorch: no kernel may
               launch).  Then reddit (run_reddit): the R-MAT graph at
               REDDIT_SCALE of reddit's size (232,965 nodes, 114,615,892
               edges), built on the host through the native graph library
               (its calls asserted) and cached in a fresh directory as the
               trainers do (MoNet's run reads that cache); GAT
               (heads (4, 1), hidden 64, attn_drop 0.3) and MoNet (2
               kernels, as the bench's gmm_reddit_*), both with bf16
               gathers, REDDIT_STEPS steps and the evals through the
               trainers' entry points, launches exact (the bf16 bin
               instances and the dense kernels), logits finite; it prints
               the host build's seconds and peak memory, the hub blocks'
               tiles, edges and widest row, ms/step, inference ms, peak MB,
               eager against replayed ms a step (REDDIT_STEPS each),
               and each kernel of the path on that graph at both layers'
               widths beside its bound; then K5 against its plain version
               on GAT's forward block with one column's ac lifted
               (check_far_rows: the rows that miss it are walked again by
               K5's second launch), both dense dtypes.
     memory  - in the same cache directory, scripts/memory_report_torch.py's
               rows (run): the JAX memory report's GAT step (heads (4, 1),
               hidden 64, feat_drop 0.5, attn_drop 0, Adam with weight
               decay, cross entropy over all nodes) fused with float32 and
               with bf16 gathers on reddit at scale 1 (read from the
               cache), naive (ops/naive.py) and fused at the cut scales
               1/64, 1/32, 1/16, 1/8 (built there; a scale whose predicted
               naive peak passes 75 % of the card is left out): resident
               and peak MB measured, the bytes autograd saves counted; the
               naive peak's straight-line fit read at scale 1 (largest
               relative residual at most FIT_RESIDUAL) beside its saved
               bytes extrapolated there.  Launches exact for every row (the
               report checks them; the naive step none), the losses finite,
               fused below naive at every cut scale, every measured peak at
               least its counted saved bytes.
               Then scripts/train_edgeconv_torch.py at full width (B = 64,
               P = 1024, k = 40, DGCNN's default dims, 512 train and 128
               test synthetic clouds) through the JAX trainer's protocol:
               the training timed by time_epoch_loop over the trainer's
               epoch (make_epoch: the shuffle, the augmentation and 8
               steps, captured once and replayed; 1 epoch, 1 warmup epoch,
               doubled until 2 s) on a throwaway copy, then exactly 2
               run_epochs replays from the initial state, the inference
               pass timed by the loop.  The loss must be finite and fall;
               masked_max ("step8", the model's schedule) and its list pass
               must have launched exactly (train steps + eval batches) x 4
               layers times and tie_sum_bwd and its list pass train steps
               x 4 (the steps and
               batches counted on the card), no other kernel at all; the
               trained model's logits on two test clouds must match a CPU
               copy's (masks compared first).  Phase loop then runs
               EC_LOOP_EPOCHS = 2 run_epochs replays of the epoch against 2
               eager epochs from the same state and generator state: the
               losses, every parameter and BatchNorm buffer within
               LOOP_TOL (bit-equality printed), launches exact, eager
               against replayed ms an epoch.  Then
               scripts/microbench_gather_torch.py, the only path of the two
               gather kernels, and scripts/exp_ec_tiles_torch.py, the only
               path of masked_max's "step1" schedule, with their launches
               counted.
  6. baselines - native: the host build of pubmed (dense=None), of cora
               with its planner's hub block and of the skewed graph under
               its forced block (the kernels phase's), through the native
               library and through the numpy versions (DGNN_TPU_NATIVE=0):
               every array equal, the library's calls counted, both times;
               the library's R-MAT generator (rmat_edges) at reddit's size,
               twice: equal, ids in range, its seconds beside the numpy
               generator's in the reddit phase.
               primitives: spmm, sddmm, edge_softmax and edge_transpose on
               pubmed (dense=None, edge tables) at H = 4, F = 64 on the card
               against CPU copies, out and every gradient (rtol 1e-5 / atol
               1e-5; gradients rtol 1e-4 / atol 1e-5).  naive: gat_naive
               against gat_aggregate on the card (pubmed, p 0 and 0.3, out
               and gradients), gmm_naive against the flat gmm_aggregate
               (pubmed), and on cora the size of their difference (its hub
               block counts a duplicate edge once, the naive sum every
               copy); then scripts/train_gat_torch.py --impl naive and
               --impl fused at the bench width on pubmed and cora, 20 steps
               each (ms/step, inference ms, peak MB, test accuracy; launches
               exact: none for naive; card logits against a CPU copy).
               checkpoint: scripts/train_edgeconv_torch.py at full width on
               320 clouds (its whole protocol, 1 epoch) saves after
               training; the trainer's restore into a
               model of another seed gives the run's eval logits exactly,
               and a second run with --load-model-path restores the step.
  7. sharded - the sharded path (dgnn_tpu_torch/parallel), SHARD_P = 4
               ranks sharing the card (parallel.run_ranks: spawned
               processes in one gloo group; the exchange route printed).
               Every comparison deduplicates its edge list first (a hub
               block counts a repeated edge once, the bins every copy).
               Synthetic pubmed (dense="auto") and cora (a forced
               CORA_SHARD_FORCED block a shard and direction) in 4 shards,
               and reddit's R-MAT graph at SHARD_REDDIT_SCALE
               (dense="auto"); on shard 1 the GAT kernels given the
               shard's table of global ids (the "_gid" instances of K1,
               K2, K5, K6) against their plain versions, p 0.3, at each
               graph's layer widths (reddit's those of its training run
               below; sum_tol / BLOCK_TOL with its atol grown with the
               shard's widest block row, both dense dtypes), and timed
               with and without the table beside their bounds.  Then
               ShardedGAT (hidden 64, heads (4, 1), attn_drop 0.3 with the
               single-device model's seeds, feat_drop 0) on pubmed and on
               cora's forced blocks, ShardedMoNet (hidden 64, K 3, dim 2)
               with node pseudo on cora's forced blocks and binned pseudo
               on pubmed, each against the single-device port model on
               the card with the same weights (dense_dtype float32):
               output (SHARD_FWD_TOL) and every parameter gradient
               (SHARD_GRAD_TOL) of the masked cross entropy, on every
               rank, and each rank's launches in that pass exactly those
               its layout implies (the binned-pseudo MoNet none).  DGCNN
               batch data parallel (ShardedDGCNN, B = 64 clouds of 1024
               points, k = 40, the trainer's widths, dropout 0.5, 16
               clouds a rank): one training step against the single-device
               port DGCNN's on the whole batch, same weights, clouds and
               generator seed: logits (SHARD_FWD_TOL), the summed loss and
               every parameter gradient (SHARD_GRAD_TOL; the EdgeConv
               layers' EC_DP_CONV_TOL, at bf16's scale; a bias that feeds a
               batch norm, whose gradient is 0, within SHARD_GRAD_TOL's
               share of the model's largest), the batch norms'
               running statistics over the global batch (SHARD_FWD_TOL,
               equal on every rank), each rank's launches exactly 4 each of
               masked_max_step8, masked_max_live_lists, tie_sum_bwd and
               tie_sum_lists.  Then 23 steps (3 of them warmup) through
               parallel.trainer of sharded GAT at the bench width
               (feat_drop 0.5, attn_drop 0.3, Adam 1e-3) on pubmed and on
               the reddit cut, each rank's launches exactly the gid
               instances' (one list call a direction and layer, the hub
               kernels where the shard has a block; nothing else); of
               sharded MoNet (hidden 64, K 3, dim 2, dropout 0.5, Adam
               1e-2, node pseudo deg^-1/2 on both ends) on pubmed and on
               cora's forced blocks, launches exact (K3, K4; K7, K8 on
               cora); of DGCNN (train_dgcnn_rank: each epoch's shuffle and
               augmentation drawn the same on every rank, SGD 0.1 with its
               cosine) at P = 1, 2 and 4, launches and all-reduces exact,
               the ranks' final parameters and statistics equal bit for
               bit.  Every loss finite and falling.  Prints ms a step at
               P = 1, 2, 4 (GAT on pubmed; DGCNN), the halo rows and bytes
               an exchange, the all-reduces' bytes a step, the route and
               the peak MB a rank.
  8. times   - each kernel and its plain version, CUDA events, in turns:
               the bin kernels over one pass of pubmed's bins, the dense
               kernels over cora's hub block, at both layers' widths
               ((H, F) = (4, 64) and (1, 7), p 0.3; (K, F) = (3, 64) and
               (3, 7)), bf16; the bin kernels' bf16 instances over the same
               bins and tables; the four bin kernels in their list form and
               the four dense kernels read from a replayed CUDA graph,
               summed to a pubmed (bins) or cora (dense) training step
               beside the step's bound; the bin kernels also beside one
               launch a bin.  Then
               one
               gat_aggregate and one gmm_aggregate_node forward + backward
               on cora with its hub block against the all-binned build of
               the same graph, and a 1 GiB device-to-device copy.
               masked_max in both schedules, and its list pass alone, at
               the model's widths F = 256, 128 and 64 with the model's
               bfloat16 mask at B = 64, P = 1024 (and equal to the plain
               version there too), each beside its own bound; tie_sum_bwd
               on that max at each width (a replayed CUDA graph, and from
               the host), beside _dsrc_ties on the card and held to it
               bit for bit, beside its bound (the mask, m, h_src, g once,
               d_src once; the operations of the pairs its filter keeps),
               and summed to a DGCNN step (widths 64, 64, 128, 256), with
               its list pass alone (tie_sum_lists) beside that pass's
               plain version and bound; and the op around them forward +
               backward in both backward modes;
               gather_rows_sum and gather_lanes at the study's shapes,
               beside the one library call that computes the same function
               (embedding_bag, torch.gather; timed here, used nowhere);
               gather_lanes and torch.gather from a replayed CUDA graph of
               20 calls, since one call is shorter on the card than the
               host takes to launch it; gather_rows_sum also beside its
               all-miss traffic (every named row from device memory) and
               its time on a table the L2 holds whole (the same ids into
               L2_ROWS rows, every repeat an L2 hit), with the rate of
               gathered rows it reaches there.
               Each kernel's bound is the larger of its bytes (every input
               tensor read once, of a hub block's node tables and of
               gather_rows_sum's table the distinct rows the ids name, every
               output written once) over 3.35 TB/s
               and its operations (FLOPS_PER_EDGE) over 67 TFLOP/s float32,
               the H100's published peaks.

The last lines are a JSON object with every kernel, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

import contextlib
import copy
import importlib.util
import json
import pathlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
# A hub-block row sums up to thousands of terms (a bin segment at most
# 128), in another order in the kernel than in the plain version.
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 mode rounds the same operands on both sides, so the kernel and its
# plain version on the card should agree to summation order.  Where the two
# sides' weights differ by an ulp (the CPU's exp against the card's, or
# merged M, L in another order), a weight can cross a bf16 rounding boundary
# and move that one term by 2^-8 of itself: at most BF16_FLIPS of the
# elements may then leave the float32 tolerance, none may leave BF16_BOUND
# (the bf16-vs-float32 tolerance of tests/test_dense_block.py).
BF16_FLIPS = 1e-3
BF16_BOUND = dict(rtol=2e-2, atol=2e-2)
SLOPE = 0.2
# the GAT backward kernels' node tables, in their arguments' order
GAT_BWD_KEYS = ("g", "ar", "M", "Linv", "ws", "ac", "feat")
SEED = 0x9E3779B9  # a uint32 dropout seed above the int32 range
SHAPES = ((4, 64), (1, 3))  # (H, F) of pubmed's hidden and output layers
DENSE_SHAPES = ((4, 64), (1, 7))  # (H, F) of cora's hidden and output layers
REDDIT_SHAPES = ((4, 64), (1, 41))  # (H, F) of reddit's GAT layers
DENSE_DTYPES = ("float32", "bfloat16")
PUBMED_FORCED = (1000, 5000)  # a forced pubmed block: 4 x 3 tiles
PL_FORCED = (512, 3000)  # a forced block of hub_graph: 2 x 2 tiles
STAR = dict(n=48_000, fan=40_000, r=512)  # star_graph: rows K7/K8 cut
# planted_graph: the tests' tiny R-MAT under dense="auto", one block column's
# source coefficient lifted by "lift" (tests/test_torch_hub_max.py)
PLANT = dict(n=300, draws=6000, lift=400.0)
CORA_MIN_ACC = 0.4  # 7 classes: chance is 1/7; 20 CPU steps reach 0.72
# Scale of the random output gradients.  d ac is a difference of sums of
# terms up to |x| |g| F, so its float32 rounding floor grows with |g|: at
# unit scale and F = 64 it reaches the stated atol (1e-5) on a few elements
# in any summation order.  The main path's gradients, of a loss averaged
# over the training rows, are about 1e-4; 1/16 keeps them far above that,
# and a wrong slot, weight or dropout bit still moves the result by far
# more than the tolerance.
G_SCALE = 1.0 / 16
GMM_SHAPES = ((3, 64), (3, 3))  # (K, F) of pubmed's hidden and output layers
GMM_DENSE_SHAPES = ((3, 64), (3, 7))  # (K, F) of cora's layers
GMM_D = 2  # projected pseudo dimensions; Ds = Dd = 1 as the trainer's
# MoNet's parameter gradients (mu, inv_sigma, the pseudo projection) are
# sums over every edge of signed terms of about unit size, taken in another
# order on the card than on the CPU: float32's 2^-23 per summed term is the
# floor, so the absolute tolerance grows with the edge count.
PARAM_TOL = dict(rtol=1e-4, atol_per_edge=2.0 ** -23)
# DGCNN at the width of the JAX bench's edgeconv_modelnet_train
EC_B, EC_P, EC_K = 64, 1024, 40
EC_LAYERS = ((3, 64), (64, 64), (64, 128), (128, 256))  # (in, out) per layer
EC_OP_SHAPE = (2, 256, 96)  # (B, P, F) of the op check: the CPU holds it
EC_F32_TOL = dict(rtol=1e-5, atol=1e-6)
EC_BF16_TOL = dict(rtol=5e-3, atol=2e-2)  # mul_dtype bfloat16
# Card against CPU, the trained DGCNN in eval mode on two clouds, the CPU
# copy given the card's masks: float32 matrix products in another order,
# four layers and three dense layers deep (the other trainers' tolerance;
# the H100 read 3e-6).
EC_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# Share of mask entries that may differ between the card's and the CPU's
# k-NN masks: a distance that differs by an ulp between the two matrix
# products can cross the bfloat16 threshold (the H100 read at most 7 of
# 2,097,152 a layer).
EC_MASK_FLIPS = 1e-4
# The loop phase: steps a side in the replayed-against-eager comparison; steps
# a side in the eager-against-replayed times (REDDIT_STEPS on reddit); the
# tolerance (atol: this times each tensor's largest element): a replayed
# step runs the eager step's kernels on the same inputs, so only an
# atomics order or a cuBLAS algorithm that the capture stream picks
# differently could part them.
LOOP_STEPS = 20
LOOP_TIME_STEPS = 50
LOOP_TOL = dict(rtol=1e-5, atol_scale=1e-6)
# DGCNN's loop: epochs a side (8 steps each at the trainer's defaults), and
# epochs a side in the eager-against-replayed times
EC_LOOP_EPOCHS = 2
EC_LOOP_TIME_EPOCHS = 2
# the tie-sum backward's check: the model's clouds a case (the CPU holds
# the plain version at P = 1024), the adversarial masks' shape, and a shape
# past the sum kernel's 1024-row chunk (odd P: the list pass's scalar reads)
EC_TIE_B = 4
EC_TIE_ODD = (2, 300, 70)
EC_TIE_LONG = (2, 1101, 70)
# The reddit phase: the cut of reddit's nodes and edges it runs at (the
# largest of 1, 1/2, 1/4, 1/8 whose host build, with the rest of the
# script, fits the script's time limit), and its training steps.
REDDIT_SCALE = 1.0
REDDIT_STEPS = 5
# The memory phase: the largest relative residual of the naive peak's
# straight-line fit over its cut scales
FIT_RESIDUAL = 0.05
# The sharded phase: ranks sharing the card, the reddit cut it trains at,
# cora's forced per-shard block (R, C), training steps (after the warmup
# ones; fewer for the P = 1, 2 timings).
SHARD_P = 4
SHARD_REDDIT_SCALE = 0.05
CORA_SHARD_FORCED = (256, 2048)
SHARD_STEPS = 20
SHARD_WARMUP = 3
SHARD_SCALING_STEPS = 10
# the data-parallel DGCNN step's comparison, and what one training step of
# it launches on a rank: the masked max and its list pass a layer forward,
# the tie-sum backward and its list pass a layer backward
EC_DP = "dgcnn data-parallel step"
# Its gradients, P ranks against one device.  The EdgeConv layers' come
# through the tie-sum backward, which rounds g to bf16 (mul_dtype), and
# through the masked max's exact ties, which a float32 ulp of the features
# (matrix products on 16 clouds' rows, not 64) can resolve otherwise, so
# they differ at bf16's scale: the H100 read 3.0e-3 of the tensor's largest
# element on conv_0's theta, 1.2e-3 on conv_1's, against at most 4e-6 in
# the rest of the model.  A bias that feeds a batch norm (proj's, the
# embeddings') has gradient 0 exactly (the norm removes any shift), so both
# sides hold rounding only (3e-8 on the H100): it is held to SHARD_GRAD_TOL's
# share of the model's largest gradient element.
EC_DP_CONV_TOL = dict(rtol=5e-3, atol_scale=1e-2)
EC_DP_LAUNCHES = dict(masked_max_step8=4, masked_max_live_lists=4,
                      tie_sum_bwd=4, tie_sum_lists=4)
# Sharded against single-device on the card, both float32: the same sums in
# another order (the shards' partials merge through other combine tables,
# and the dense projections run on other matrix shapes), so an element's
# error scales with the terms it sums, not with itself: atol is a share of
# the tensor's largest element (the H100 read 2.9e-5 on one MoNet cora
# output element, 5.7e-3 of that element).
SHARD_FWD_TOL = dict(rtol=1e-4, atol_scale=1e-5)
SHARD_GRAD_TOL = dict(rtol=1e-3, atol_scale=1e-4)
# gather_rows_sum is also timed on a table of this many rows (16.8 MB at the
# study's 4 KB rows), which stays in the H100's 50 MB L2 whole.
L2_ROWS = 4096
# The H100's published peaks (SXM): HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
KERNELS = {
    "bin_gat_fwd": dict(route="cuda", source="dgnn_tpu_torch/csrc/bin_gat.cu",
                        replaces="dgnn_tpu/ops/pallas_bins.py:225"),
    "bin_gat_bwd": dict(route="cuda", source="dgnn_tpu_torch/csrc/bin_gat.cu",
                        replaces="dgnn_tpu/ops/pallas_bins.py:359"),
    "bin_gat_fwd_bf16": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gat.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:225"),
    "bin_gat_bwd_bf16": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gat.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:359"),
    "dense_gat_fwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gat.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:265"),
    "dense_gat_bwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gat.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:430"),
    "bin_gmm_node_fwd": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:453"),
    "bin_gmm_node_bwd": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                             replaces="dgnn_tpu/ops/pallas_bins.py:554"),
    "bin_gmm_node_fwd_bf16": dict(route="cuda",
                                  source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                                  replaces="dgnn_tpu/ops/pallas_bins.py:453"),
    "bin_gmm_node_bwd_bf16": dict(route="cuda",
                                  source="dgnn_tpu_torch/csrc/bin_gmm.cu",
                                  replaces="dgnn_tpu/ops/pallas_bins.py:554"),
    "dense_gmm_fwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gmm.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:539"),
    "dense_gmm_bwd": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/dense_gmm.cu",
                          replaces="dgnn_tpu/ops/pallas_dense.py:648"),
    "masked_max_step1": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/ec_tiles.cu",
                             replaces="scripts/exp_r5_ec_tiles.py:59"),
    "masked_max_step8": dict(route="cuda",
                             source="dgnn_tpu_torch/csrc/ec_tiles.cu",
                             replaces="scripts/exp_r5_ec_tiles.py:97"),
    # the list pass both schedules start with (no kernel of its own on the
    # TPU, where both kernels walk the whole mask)
    "masked_max_live_lists": dict(route="cuda",
                                  source="dgnn_tpu_torch/csrc/ec_tiles.cu",
                                  replaces="scripts/exp_r5_ec_tiles.py:59"),
    # the tie-sum backward of edge_conv_max_dense (no Pallas kernel on the
    # TPU: an XLA pass there); its ms is the whole call, its list pass's
    # included
    "tie_sum_bwd": dict(route="cuda",
                        source="dgnn_tpu_torch/csrc/ec_ties.cu",
                        replaces="dgnn_tpu/ops/edgeconv.py:184",
                        note="the JAX version (_ecd_dsrc_ties) is an XLA "
                             "pass, not a Pallas kernel; ms: the whole call "
                             "(list pass and sum)"),
    # its list pass (bounds and lists), timed alone
    "tie_sum_lists": dict(route="cuda",
                          source="dgnn_tpu_torch/csrc/ec_ties.cu",
                          replaces="dgnn_tpu/ops/edgeconv.py:184",
                          note="the list pass of tie_sum_bwd: the pair "
                               "filter of the XLA pass _ecd_dsrc_ties"),
    "gather_rows_sum": dict(route="cuda",
                            source="dgnn_tpu_torch/csrc/gather.cu",
                            replaces="scripts/microbench_gather.py:99"),
    "gather_lanes": dict(route="cuda",
                         source="dgnn_tpu_torch/csrc/gather.cu",
                         replaces="scripts/microbench_gather.py:148"),
}
# the GAT kernels given a shard's table of global ids (the sharded path)
for _k in ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd"):
    KERNELS[_k + "_gid"] = dict(KERNELS[_k])
# Float32 operations per edge that each function needs, by (C, G) = (feature
# columns, heads or Gaussian kernels): a multiply-add per column and
# weighted sum, plus the edge's score or Gaussian weights (a dozen
# operations per head or kernel).  The backward adds the <x, g> products.
FLOPS_PER_EDGE = {
    "bin_gat_fwd": lambda C, G: 4 * C + 12 * G,    # acc and accpos
    "bin_gat_bwd": lambda C, G: 4 * C + 14 * G,    # dx and <x, g>
    "bin_gmm_node_fwd": lambda C, G: 2 * C + 12 * G,
    "bin_gmm_node_bwd": lambda C, G: 4 * C + 30 * G,
}
# masked max: an add and a max per ADMITTED candidate and column (a kernel
# need not touch a candidate the mask refuses); the gathers: an add per
# gathered row and column, and none
for _k in ("masked_max_step1", "masked_max_step8"):
    FLOPS_PER_EDGE[_k] = lambda C, G: 2 * C
# the list pass: an add and a compare per mask entry
FLOPS_PER_EDGE["masked_max_live_lists"] = lambda C, G: 2
# the tie-sum backward: an add, a compare and a sum per column of each pair
# that can tie (the pairs its filter keeps); its list pass an add and a
# compare per mask entry
FLOPS_PER_EDGE["tie_sum_bwd"] = lambda C, G: 3 * C
FLOPS_PER_EDGE["tie_sum_lists"] = lambda C, G: 2
FLOPS_PER_EDGE["gather_rows_sum"] = lambda C, G: C
FLOPS_PER_EDGE["gather_lanes"] = lambda C, G: 0
for _k in ("gat_fwd", "gat_bwd"):
    FLOPS_PER_EDGE["dense_" + _k] = FLOPS_PER_EDGE["bin_" + _k]
for _k in ("fwd", "bwd"):
    FLOPS_PER_EDGE["dense_gmm_" + _k] = FLOPS_PER_EDGE["bin_gmm_node_" + _k]
# the bf16 instances do the float32 instances' operations on narrower rows
for _k in ("bin_gat_fwd", "bin_gat_bwd", "bin_gmm_node_fwd",
           "bin_gmm_node_bwd"):
    FLOPS_PER_EDGE[_k + "_bf16"] = FLOPS_PER_EDGE[_k]
# and the gid instances those of the kernels without the table
for _k in ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd"):
    FLOPS_PER_EDGE[_k + "_gid"] = FLOPS_PER_EDGE[_k]


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tables(gat_forward, graph, h, f, rng, dev):
    """Node tables for one (H, F) shape: random features, coefficients and
    output gradient made with numpy, and the backward's destination tables
    (M, 1 / L, ws = <g, out>) as the op's forward gives them on this graph
    (bins and hub block, float32), from its plain versions on a CPU copy.
    So the backward kernels see attention weights in [0, 1], as on the main
    path."""
    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a)

    n = graph.num_nodes
    tb = dict(feat=t(n, h, f), ac=t(n, h), ar=t(n, h),
              g=t(n, h, f, scale=G_SCALE))
    out, M, L, _, _ = gat_forward(graph.fwd.to("cpu"), tb["ar"], tb["ac"],
                                  tb["feat"], SLOPE, 0.0, 0, "float32",
                                  with_pos=False)
    tb["M"] = M
    tb["Linv"] = 1.0 / torch.clamp(L, min=1e-20)
    tb["ws"] = (tb["g"] * out).sum(dim=-1)
    return {k: v.to(dev) for k, v in tb.items()}


def assert_close(got, want, tol, dense_dtype="float32", what=""):
    """Every element within ``tol``; in bf16 mode, see BF16_FLIPS.  Returns
    the max |got - want| and the number of elements outside ``tol``."""
    off = int((~torch.isclose(got, want, **tol)).sum())
    if dense_dtype == "float32":
        torch.testing.assert_close(got, want, **tol, msg=lambda m: what + m)
    else:
        torch.testing.assert_close(got, want, **BF16_BOUND,
                                   msg=lambda m: what + m)
        assert off <= BF16_FLIPS * got.numel(), (what, off, got.numel())
    return float((got - want).abs().max()), off


def sum_tol(adj, tol):
    """``tol`` with atol at least 8 W 2^-23 for W the direction's widest bin:
    a segment sums up to W terms, in another order in the kernel."""
    return dict(tol, atol=max(tol["atol"], 8 * max(adj.widths) * 2.0 ** -23))


def list_launches(bins, adj):
    """Launches of one list-wrapper call over a direction's bins."""
    return -(-adj.num_bins // bins.MAX_BINS_PER_LAUNCH)


def with_rows(tb, rows):
    """A kernel check's tables with the feature rows (feat, g) stored as
    ``rows``: the kernels' float32 or bf16 instances."""
    return dict(tb, feat=tb["feat"].to(rows), g=tb["g"].to(rows))


def card_seed(like, dtype=torch.int64):
    """SEED in device memory, as a step hands the kernels an element of the
    seed table it drew on the card: an int64 (the kernels read its low
    word) or the bits of an int32.  The plain versions take the int."""
    bits = SEED - (1 << 32) if dtype == torch.int32 else SEED
    return torch.tensor(bits, dtype=dtype, device=like.device)


def hold(bins, err, name, rows, got, want, tol, what=""):
    """One kernel output against its plain version on the same inputs,
    every element within ``tol`` whether the feature rows are float32 or
    bf16 (both sides widen the same bf16 values exactly, so only float32
    summation order tells them apart), the largest difference recorded
    under the kernel's name (``_bf16`` for bf16 rows)."""
    key = bins.launch_name(name, rows == torch.bfloat16)
    torch.testing.assert_close(got, want, **tol,
                               msg=lambda m: f"{key} {what}: {m}")
    err[key] = max(err[key], float((got - want).abs().max()))


def check_bins(bins, adj_fwd, adj_bwd, tb, err, rows=torch.float32):
    """Every bin of one graph, kernel against plain, feature rows stored as
    ``rows``; returns the number of comparisons."""
    tb = with_rows(tb, rows)
    ks = dict(seed=card_seed(tb["ac"]))  # the kernels' seed: an int64
    n_cmp = 0
    for _w, nbr, _e, row, count in adj_fwd.bins():
        for p in (0.0, 0.3):
            for with_pos in (True, False):
                args = (tb["feat"], tb["ac"], tb["ar"], nbr, row, count)
                kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED)
                got = bins.bin_gat_fwd(*args, **kw | ks)
                want = bins.bin_gat_fwd_plain(*args, **kw)
                for g, w in zip(got, want):
                    if w is None:
                        assert g is None
                        continue
                    hold(bins, err, "bin_gat_fwd", rows, g, w, FWD_TOL)
                n_cmp += 1
    # every bin in one launch (the op's path)
    segs = adj_fwd.segs()
    for p in (0.0, 0.3):
        for with_pos in (True, False):
            args = (tb["feat"], tb["ac"], tb["ar"], segs)
            kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED)
            got = bins.bin_gat_fwd_list(*args, **kw | ks)
            want = bins.bin_gat_fwd_list_plain(*args, **kw)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                    continue
                hold(bins, err, "bin_gat_fwd", rows, g, w,
                     sum_tol(adj_fwd, FWD_TOL), "list")
            n_cmp += 1
    dst = tuple(tb[k] for k in GAT_BWD_KEYS)
    for _w, nbr, _e, row, count in adj_bwd.bins():
        for p in (0.0, 0.3):
            args = (*dst, nbr, row, count)
            kw = dict(slope=SLOPE, p=p, seed=SEED)
            got = bins.bin_gat_bwd(*args, **kw | ks)
            want = bins.bin_gat_bwd_plain(*args, **kw)
            for g, w in zip(got, want):
                hold(bins, err, "bin_gat_bwd", rows, g, w, BWD_TOL)
            n_cmp += 1
    # the backward's every bin in one launch (the op's path)
    for p in (0.0, 0.3):
        kw = dict(slope=SLOPE, p=p, seed=SEED)
        got = bins.bin_gat_bwd_list(*dst, adj_bwd.segs(), **kw | ks)
        want = bins.bin_gat_bwd_list_plain(*dst, adj_bwd.segs(), **kw)
        for g, w in zip(got, want):
            hold(bins, err, "bin_gat_bwd", rows, g, w,
                 sum_tol(adj_bwd, BWD_TOL), "list")
        n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def check_dense(dense, graph, tb, err, tol=BLOCK_TOL):
    """Both dense kernels against their plain versions on one graph's hub
    blocks; returns (comparisons, elements outside the float32 tolerance)."""
    n_cmp = n_off = 0
    # the kernels' seed: the bits of an int32
    ks = dict(seed=card_seed(tb["ac"], torch.int32))
    for dt in DENSE_DTYPES:
        for p in (0.0, 0.3):
            for with_pos in (True, False):
                args = (graph.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
                kw = dict(slope=SLOPE, with_pos=with_pos, p=p, seed=SEED,
                          dense_dtype=dt)
                got = dense.dense_gat_fwd(*args, **kw | ks)
                want = dense.dense_gat_fwd_plain(*args, **kw)
                for name, g, w in zip(("m", "l", "lpos", "acc", "accpos"),
                                      got, want):
                    if w is None:
                        assert g is None
                        continue
                    e, off = assert_close(g, w, tol, dt,
                                          f"dense_gat_fwd {name} {dt} p={p}: ")
                    err["dense_gat_fwd"] = max(err["dense_gat_fwd"], e)
                    n_off += off
                n_cmp += 1
            args = (graph.bwd.dense, *(tb[k] for k in (
                "g", "ar", "M", "Linv", "ws", "ac", "feat")))
            kw = dict(slope=SLOPE, p=p, seed=SEED, dense_dtype=dt)
            got = dense.dense_gat_bwd(*args, **kw | ks)
            want = dense.dense_gat_bwd_plain(*args, **kw)
            for name, g, w in zip(("dx", "dac"), got, want):
                e, off = assert_close(g, w, tol, dt,
                                      f"dense_gat_bwd {name} {dt} p={p}: ")
                err["dense_gat_bwd"] = max(err["dense_gat_bwd"], e)
                n_off += off
            n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp, n_off


def gmm_tables(n, k, f, rng, dev):
    """Node tables and parameters of one MoNet pass at (K, F), made with
    numpy: features, the output gradient (at G_SCALE), both halves of the
    projected pseudo-coordinate, the raw pseudo scalars, and the kernels'
    means and inverse widths."""
    def t(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    return dict(feat=t(n, k, f), g=t(n, k, f, scale=G_SCALE),
                alpha=t(n, GMM_D), beta=t(n, GMM_D), sfeat=t(n, 1),
                dfeat=t(n, 1), mu=t(k, GMM_D), isig=torch.from_numpy(
                    (rng.random((k, GMM_D)) + 0.5).astype(np.float32)).to(dev))


def gmm_bin_args(tb, nbr, row, count):
    """(forward, backward) argument tuples of one bin."""
    seg = (nbr, row, count, tb["mu"], tb["isig"])
    return ((tb["feat"], tb["alpha"], tb["beta"], *seg),
            (tb["g"], tb["beta"], tb["dfeat"], tb["alpha"], tb["feat"],
             tb["sfeat"], *seg))


def gmm_list_fwd_args(tb, segs):
    """Forward arguments of bin_gmm_node_fwd_list over ``segs``."""
    return (tb["feat"], tb["alpha"], tb["beta"], segs, tb["mu"], tb["isig"])


def gmm_list_bwd_args(tb, segs):
    """Backward arguments of bin_gmm_node_bwd_list over ``segs``."""
    return (tb["g"], tb["beta"], tb["dfeat"], tb["alpha"], tb["feat"],
            tb["sfeat"], segs, tb["mu"], tb["isig"])


def gmm_dense_args(graph, tb):
    """(forward, backward) argument tuples of one graph's hub blocks."""
    par = (tb["mu"], tb["isig"])
    return ((graph.fwd.dense, tb["beta"], tb["alpha"], tb["feat"], *par),
            (graph.bwd.dense, tb["g"], tb["beta"], tb["dfeat"], tb["alpha"],
             tb["feat"], *par))


def check_gmm_bins(bins, adj_fwd, adj_bwd, tb, err, rows=torch.float32):
    """Every bin of one graph, MoNet kernels against their plain versions,
    tanh on and off, feature rows stored as ``rows``; returns the number of
    comparisons."""
    tb = with_rows(tb, rows)
    n_cmp = 0
    for use_tanh in (True, False):
        for _w, nbr, _e, row, count in adj_fwd.bins():
            args = gmm_bin_args(tb, nbr, row, count)[0]
            got = bins.bin_gmm_node_fwd(*args, use_tanh=use_tanh)
            want = bins.bin_gmm_node_fwd_plain(*args, use_tanh=use_tanh)
            hold(bins, err, "bin_gmm_node_fwd", rows, got, want, FWD_TOL)
            n_cmp += 1
        # every bin of each direction in one launch (the op's path)
        args = gmm_list_fwd_args(tb, adj_fwd.segs())
        got = bins.bin_gmm_node_fwd_list(*args, use_tanh=use_tanh)
        want = bins.bin_gmm_node_fwd_list_plain(*args, use_tanh=use_tanh)
        hold(bins, err, "bin_gmm_node_fwd", rows, got, want,
             sum_tol(adj_fwd, FWD_TOL), "list")
        n_cmp += 1
        for _w, nbr, _e, row, count in adj_bwd.bins():
            args = gmm_bin_args(tb, nbr, row, count)[1]
            got = bins.bin_gmm_node_bwd(*args, use_tanh=use_tanh)
            want = bins.bin_gmm_node_bwd_plain(*args, use_tanh=use_tanh)
            for name, g, w in zip(("dx", "stat rows"), got, want):
                hold(bins, err, "bin_gmm_node_bwd", rows, g, w, BWD_TOL,
                     name)
            n_cmp += 1
        args = gmm_list_bwd_args(tb, adj_bwd.segs())
        got = bins.bin_gmm_node_bwd_list(*args, use_tanh=use_tanh)
        want = bins.bin_gmm_node_bwd_list_plain(*args, use_tanh=use_tanh)
        for name, g, w, tol in zip(("dx", "stat rows"), got, want,
                                   (FWD_TOL, BWD_TOL)):
            hold(bins, err, "bin_gmm_node_bwd", rows, g, w,
                 sum_tol(adj_bwd, tol), f"list {name}")
        n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def check_gmm_dense(dense, graph, tb, err, tol=BLOCK_TOL):
    """Both dense MoNet kernels against their plain versions on one graph's
    hub blocks; returns (comparisons, elements outside the float32
    tolerance)."""
    n_cmp = n_off = 0
    fwd_args, bwd_args = gmm_dense_args(graph, tb)
    for dt in DENSE_DTYPES:
        for use_tanh in (True, False):
            kw = dict(use_tanh=use_tanh, dense_dtype=dt)
            got = dense.dense_gmm_fwd(*fwd_args, **kw)
            want = dense.dense_gmm_fwd_plain(*fwd_args, **kw)
            e, off = assert_close(got, want, tol, dt,
                                  f"dense_gmm_fwd acc {dt} tanh={use_tanh}: ")
            err["dense_gmm_fwd"] = max(err["dense_gmm_fwd"], e)
            n_off += off
            got = dense.dense_gmm_bwd(*bwd_args, **kw)
            want = dense.dense_gmm_bwd_plain(*bwd_args, **kw)
            for name, g, w in zip(("dx", "stat rows"), got, want):
                e, off = assert_close(
                    g, w, tol, dt,
                    f"dense_gmm_bwd {name} {dt} tanh={use_tanh}: ")
                err["dense_gmm_bwd"] = max(err["dense_gmm_bwd"], e)
                n_off += off
            n_cmp += 2
    torch.cuda.synchronize()
    return n_cmp, n_off


def check_gmm_cut(dense, graph, tb, err, tol):
    """check_gmm_dense on a graph whose blocks K7/K8 walk as work lists with
    rows cut into pieces (one merge launch a call), and a second launch of
    each kernel equal to the first bit for bit; returns (comparisons,
    elements outside ``tol``, the two directions' lists)."""
    lists = [dense.gmm_work(adj.dense) for adj in (graph.fwd, graph.bwd)]
    for wl in lists:
        assert wl is not None and wl.split_rows >= 1, wl
    merges = dense.LAUNCHES["dense_gmm_merge"]
    n_cmp, n_off = check_gmm_dense(dense, graph, tb, err, tol)
    assert dense.LAUNCHES["dense_gmm_merge"] == merges + n_cmp, (
        dense.LAUNCHES, merges, n_cmp)
    fwd_args, bwd_args = gmm_dense_args(graph, tb)
    for dt in DENSE_DTYPES:
        kw = dict(use_tanh=True, dense_dtype=dt)
        for fn, args in ((dense.dense_gmm_fwd, fwd_args),
                         (dense.dense_gmm_bwd, bwd_args)):
            one, two = fn(*args, **kw), fn(*args, **kw)
            for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (one, two))):
                assert torch.equal(a, b), (fn.__name__, dt)
    torch.cuda.synchronize()
    return n_cmp, n_off, lists


def block_stats(adj):
    """Tiles, padded rows x columns and edges of one direction's block."""
    db = adj.dense
    return (f"T={db.mask.shape[0]} {db.row_ids.shape[0]}x"
            f"{db.col_ids.shape[0]} {block_edges(db)} edges")


def block_edges(db):
    return int(block_row_edges(db).sum())


def block_inputs(db, by_row, by_col, whole=()):
    """A hub block's inputs for ``bound``: its ids, mask and schedule in
    full, and of each node table the rows that row_ids (by_row) or col_ids
    (by_col) name."""
    n_row = int(torch.unique(db.row_ids).numel())
    n_col = int(torch.unique(db.col_ids).numel())
    return ([db.row_ids, db.col_ids, db.mask, db.ct, db.chunk_ptr, *whole]
            + [(t, n_row) for t in by_row] + [(t, n_col) for t in by_col])


def bound(name, inputs, outputs, edges, columns, groups):
    """(bound_ms, bound_by) of one timed function on this run's inputs: the
    larger of its bytes (each distinct input tensor read once, each output
    written once) over the card's memory rate and its float32 operations
    over the card's peak rate.  An input given as (table, rows) counts only
    that many of the table's rows: a hub block reads the rows its row_ids
    or col_ids name, not the whole node table."""
    seen = {}
    for t in list(inputs) + list(outputs):
        rows = None
        if isinstance(t, tuple):
            t, rows = t
        if isinstance(t, torch.Tensor):
            nbytes = t.numel() * t.element_size()
            if rows is not None:
                nbytes = nbytes // t.shape[0] * rows
            seen[t.data_ptr()] = nbytes
    by_bytes = sum(seen.values()) / PEAK_BYTES_S
    by_ops = edges * FLOPS_PER_EDGE[name](columns, groups) / PEAK_FLOPS_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def flat(results):
    """The tensors of a list of wrapper results (tuples with Nones)."""
    out = []
    for r in results:
        out += [t for t in (r if isinstance(r, tuple) else (r,))
                if t is not None]
    return out


def edges_of(adj):
    """Edges of one direction's bins."""
    return sum(int(c.sum()) for c in adj.count)


def path_jobs(bins, dense, kind, graph, tb, rows):
    """The calls the ops make of one model's kernels over ``graph`` at one
    table set's width (p 0.3, tanh): each bin kernel's list call over every
    bin of its direction, feature rows stored as ``rows``, and where the
    graph has a hub block each dense kernel on the float32 tables with bf16
    products.  {launch name: (kernel call, plain call, inputs for
    ``bound``, edges)}; each call returns a list of its results."""
    bf16 = rows == torch.bfloat16
    rt = with_rows(tb, rows)
    fwd, bwd = graph.fwd, graph.bwd
    jobs = {}
    if kind == "gat":
        fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
        bkw = dict(slope=SLOPE, p=0.3, seed=SEED)
        ks = dict(seed=card_seed(tb["ac"]))  # the kernels': from the card
        la = (rt["feat"], rt["ac"], rt["ar"], fwd.segs())
        lb = (*(rt[k] for k in GAT_BWD_KEYS), bwd.segs())
        jobs[bins.launch_name("bin_gat_fwd", bf16)] = (
            lambda: [bins.bin_gat_fwd_list(*la, **fkw | ks)],
            lambda: [bins.bin_gat_fwd_list_plain(*la, **fkw)],
            [*la[:3], *flat(la[3])], edges_of(fwd))
        jobs[bins.launch_name("bin_gat_bwd", bf16)] = (
            lambda: [bins.bin_gat_bwd_list(*lb, **bkw | ks)],
            lambda: [bins.bin_gat_bwd_list_plain(*lb, **bkw)],
            [*lb[:7], *flat(lb[7])], edges_of(bwd))
        if fwd.dense is not None:
            fa = (fwd.dense, tb["ar"], tb["ac"], tb["feat"])
            ba = (bwd.dense, *(tb[k] for k in GAT_BWD_KEYS))
            dfkw, dbkw = (dict(kw, dense_dtype="bfloat16")
                          for kw in (fkw, bkw))
            jobs["dense_gat_fwd"] = (
                lambda: [dense.dense_gat_fwd(*fa, **dfkw | ks)],
                lambda: [dense.dense_gat_fwd_plain(*fa, **dfkw)],
                block_inputs(fa[0], [tb["ar"]], [tb["ac"], tb["feat"]]),
                block_edges(fa[0]))
            jobs["dense_gat_bwd"] = (
                lambda: [dense.dense_gat_bwd(*ba, **dbkw | ks)],
                lambda: [dense.dense_gat_bwd_plain(*ba, **dbkw)],
                block_inputs(ba[0], [tb["ac"], tb["feat"]],
                             [tb[k] for k in GAT_BWD_KEYS[:5]]),
                block_edges(ba[0]))
        return jobs
    la = gmm_list_fwd_args(rt, fwd.segs())
    lb = gmm_list_bwd_args(rt, bwd.segs())
    jobs[bins.launch_name("bin_gmm_node_fwd", bf16)] = (
        lambda: [bins.bin_gmm_node_fwd_list(*la, use_tanh=True)],
        lambda: [bins.bin_gmm_node_fwd_list_plain(*la, use_tanh=True)],
        [*la[:3], *flat(la[3]), *la[4:]], edges_of(fwd))
    jobs[bins.launch_name("bin_gmm_node_bwd", bf16)] = (
        lambda: [bins.bin_gmm_node_bwd_list(*lb, use_tanh=True)],
        lambda: [bins.bin_gmm_node_bwd_list_plain(*lb, use_tanh=True)],
        [*lb[:6], *flat(lb[6]), *lb[7:]], edges_of(bwd))
    if fwd.dense is not None:
        gkw = dict(use_tanh=True, dense_dtype="bfloat16")
        gfa, gba = gmm_dense_args(graph, tb)
        par = (tb["mu"], tb["isig"])
        jobs["dense_gmm_fwd"] = (
            lambda: [dense.dense_gmm_fwd(*gfa, **gkw)],
            lambda: [dense.dense_gmm_fwd_plain(*gfa, **gkw)],
            block_inputs(gfa[0], [tb["beta"]], [tb["alpha"], tb["feat"]],
                         par), block_edges(gfa[0]))
        jobs["dense_gmm_bwd"] = (
            lambda: [dense.dense_gmm_bwd(*gba, **gkw)],
            lambda: [dense.dense_gmm_bwd_plain(*gba, **gkw)],
            block_inputs(gba[0], [tb["alpha"], tb["feat"]],
                         [tb["g"], tb["beta"], tb["dfeat"]], par),
            block_edges(gba[0]))
    return jobs


def power_law_graph(structure, rng, n=4000):
    """Zipf-skewed in-degrees: one bin wider than 64 whose hub rows split
    into several segments."""
    src = rng.integers(0, n, 6 * n)
    dst = np.minimum(rng.zipf(1.6, 6 * n) - 1, n - 1)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    g = structure.build_graph(uniq[:, 0], uniq[:, 1], n, widths=(8, 128))
    assert max(g.fwd.widths) > 64, g.fwd.widths
    return g


def hub_edges(rng, n=4000):
    """(src, dst, n): edges skewed both ways (Zipf destinations from
    uniform sources, Zipf sources to uniform destinations)."""
    e = 3 * n
    zipf = lambda: np.minimum(rng.zipf(1.6, e) - 1, n - 1)  # noqa: E731
    into = np.stack([rng.integers(0, n, e), zipf()], 1)
    out_of = np.stack([rng.permutation(n)[zipf()], rng.integers(0, n, e)], 1)
    uniq = np.unique(np.concatenate([into, out_of]), axis=0)
    return uniq[:, 0], uniq[:, 1], n


def hub_graph(structure, rng):
    """hub_edges under the forced block PL_FORCED: in each direction hub
    rows of thousands of set columns in one tile row, two column tiles a
    row chunk."""
    g = structure.build_graph(*hub_edges(rng), dense=PL_FORCED,
                              edge_tables=False)
    for adj in (g.fwd, g.bwd):
        assert widest_row(adj.dense) > 1000, widest_row(adj.dense)
        assert (np.diff(adj.dense.chunk_ptr.numpy()) == 2).all()
    return g


def star_graph(structure, rng):
    """Sparse random edges and a star of STAR["fan"] edges into node 0 and
    three quarters of that out of node 1, under a forced block of STAR["r"]
    rows and every column (the star block of tests/test_torch_dense.py):
    in each direction a row far over the work list's ROW_FLOOR."""
    n, fan = STAR["n"], STAR["fan"]
    base = rng.integers(0, n, (2 * n, 2))
    into = rng.choice(np.arange(2, n), fan, replace=False)
    out_of = rng.choice(np.arange(2, n), fan * 3 // 4, replace=False)
    src = np.concatenate([base[:, 0], into, np.full(len(out_of), 1)])
    dst = np.concatenate([base[:, 1], np.zeros(fan, np.int64), out_of])
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return structure.build_graph(uniq[:, 0], uniq[:, 1], n,
                                 dense=(STAR["r"], n), edge_tables=False)


def planted_graph(structure, dense, rmat_edges):
    """(graph, node): the R-MAT of PLANT under dense="auto", and the node of
    the block column that the most block rows link to."""
    src, dst = rmat_edges(PLANT["n"], PLANT["draws"], 0)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    g = structure.build_graph(uniq[:, 0], uniq[:, 1], PLANT["n"],
                              dense="auto", edge_tables=False)
    db = g.fwd.dense
    cols = torch.cat([c for _, c in dense._tiles(db)])
    ids, counts = db.col_ids.long()[cols].unique(return_counts=True)
    return g, int(ids[counts.argmax()])


def check_planted(dense, graph, node, rng, dev, err):
    """K5 against its plain version on ``graph``'s forward block with the
    source coefficient of block column ``node`` lifted by PLANT["lift"]
    over random tables: the block rows that do not link to it hold scores
    hundreds under the TPU kernel's row bound, where exp underflows.  m
    must agree bit for bit and be each row's exact largest score, and
    every row with an edge must keep l > 0.  Returns (comparisons, rows
    that miss the column, the least l of a row with an edge)."""
    db = graph.fwd.dense
    rows_e = block_row_edges(db)
    has = rows_e > 0
    has[db.num_rows:] = False
    n = graph.num_nodes
    ks = dict(seed=card_seed(db.mask, torch.int32))
    n_cmp, least = 0, float("inf")
    for h, f in DENSE_SHAPES:
        t = lambda *s: torch.from_numpy(  # noqa: E731
            rng.normal(size=s).astype(np.float32)).to(dev)
        ar, ac, feat = t(n, h), t(n, h), t(n, h, f)
        ac[node] += PLANT["lift"]
        for dt in DENSE_DTYPES:
            for p in (0.0, 0.3):
                kw = dict(slope=SLOPE, with_pos=True, p=p, seed=SEED,
                          dense_dtype=dt)
                got = dense.dense_gat_fwd(db, ar, ac, feat, **kw | ks)
                want = dense.dense_gat_fwd_plain(db, ar, ac, feat, **kw)
                assert torch.equal(got[0], want[0]), f"planted m {dt} p={p}"
                for name, g, w in zip(("l", "lpos", "acc", "accpos"),
                                      got[1:], want[1:]):
                    e, _ = assert_close(g, w, BLOCK_TOL, dt,
                                        f"planted {name} {dt} p={p}: ")
                    err["dense_gat_fwd"] = max(err["dense_gat_fwd"], e)
                l = got[1][has]
                assert bool((l > 0).all()), f"planted {dt} p={p}: l = 0"
                least = min(least, float(l.min()))
                n_cmp += 1
    hit = torch.zeros_like(has)
    for r, c in dense._tiles(db):
        hit[r[db.col_ids.long()[c] == node]] = True
    return n_cmp, int((has & ~hit).sum()), least


def check_far_rows(dense, graph, dev):
    """K5 against its plain version on ``graph``'s forward hub block at
    each of reddit's GAT layer widths and in both dense dtypes (p 0.3), on
    random tables with the source coefficient of the block's first column
    lifted by PLANT["lift"]: the rows that miss that column hold scores
    hundreds under the TPU kernel's row bound, so K5's second launch walks
    them again at their m.  m must agree bit for bit; l and lpos within
    1e-3 of l; a row's weighted means acc / l and accpos / l within 1e-3 of
    the largest |x| (a row of 92,682 edges sums in another order).  Returns
    (the far rows of the last call, comparisons, the largest error of a
    mean over the largest |x|)."""
    db = graph.fwd.dense
    gen = torch.Generator(device=dev).manual_seed(5)
    rid, cid = db.row_ids.long(), db.col_ids.long()
    ks = dict(seed=card_seed(db.mask, torch.int32))
    n_cmp, worst, far = 0, 0.0, 0
    for h, f in REDDIT_SHAPES:
        n = graph.num_nodes
        ar, ac = (torch.randn(n, h, generator=gen, device=dev)
                  for _ in range(2))
        feat = torch.randn(n, h, f, generator=gen, device=dev)
        ac[cid[0]] += PLANT["lift"]
        s = ar[rid] + ac[cid].amax(dim=0)
        bound = torch.where(s >= 0, s, SLOPE * s)
        top = float(feat.abs().max())
        for dt in DENSE_DTYPES:
            kw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED,
                      dense_dtype=dt)
            m, l, lpos, acc, accpos = dense.dense_gat_fwd(db, ar, ac, feat,
                                                          **kw | ks)
            wm, wl, wlpos, wacc, waccpos = dense.dense_gat_fwd_plain(
                db, ar, ac, feat, **kw)
            assert torch.equal(m, wm), f"far rows m {dt} ({h}, {f})"
            for name, g, w in (("l", l, wl), ("lpos", lpos, wlpos)):
                assert bool(((g - w).abs() <= 1e-3 * wl).all()), (
                    f"far rows {name} {dt} ({h}, {f})")
            den = wl.clamp(min=1e-30)[..., None]
            for name, g, w in (("acc", acc, wacc), ("accpos", accpos,
                                                    waccpos)):
                e = float(((g - w) / den).abs().max()) / top
                assert e <= 1e-3, (f"far rows {name} {dt} ({h}, {f})", e)
                worst = max(worst, e)
            far = int(((wm > -1e30) & (bound - wm > dense.BOUND_GAP))
                      .any(dim=1).sum())
            assert far > 0, f"far rows {dt} ({h}, {f}): none"
            n_cmp += 1
            del m, l, lpos, acc, accpos, wm, wl, wlpos, wacc, waccpos
            torch.cuda.empty_cache()
    return far, n_cmp, worst


def widest_row(db):
    """Most set columns in one tile row of a hub block."""
    bits = np.unpackbits(db.mask.cpu().numpy(), axis=-1)
    return int(bits.sum(axis=-1).max())


def hub_tol(graph, tol):
    """``tol`` with its atol grown with the blocks' widest row in units of
    128 terms (a bin segment's most): such a row sums thousands of terms in
    another order in the kernel than in the plain version (the rule of
    tests/test_torch_dense.py).  ``graph``: a Graph or a ShardView."""
    widest = max(widest_row(adj.dense) for adj in (graph.fwd, graph.bwd)
                 if adj.dense is not None)
    return dict(tol, atol=tol["atol"] * max(1.0, widest / 128))


def row_tol(graph, tol):
    """``tol`` with its atol grown with the blocks' widest row (every tile
    of its chunk) in units of 128 terms: the rule of hub_tol for a block
    whose rows K7/K8 cut into pieces, which sum a row's tiles in another
    order than the plain version."""
    widest = max(int(block_row_edges(adj.dense).max())
                 for adj in (graph.fwd, graph.bwd))
    return dict(tol, atol=tol["atol"] * max(1.0, widest / 128))


def time_turns(fns, time_calls, dev, iters):
    """ms per call of each function, measured in turns (there and back: a,
    b, c, c, b, a), the lesser of a function's two readings.  ``iters``:
    calls per reading, one number per function."""
    order = list(range(len(fns)))
    best = [float("inf")] * len(fns)
    for i in order + order[::-1]:
        t = time_calls(fns[i], dev, iters=iters[i], warmup=min(3, iters[i]))
        best[i] = min(best[i], t * 1e3)
    return best


def time_pair(fn_kernel, fn_plain, time_calls, dev):
    """ms per call of each, measured in turns: plain, kernel, kernel, plain."""
    plain_ms, ms = time_turns([fn_plain, fn_kernel], time_calls, dev, [20, 20])
    return ms, plain_ms


def check_masked_max(ec_tiles, make_inputs, dev, err):
    """masked_max in both schedules, with and without the index, against its
    plain version on the card: exactly equal, index included.  Returns the
    cases as (description, comparisons)."""
    from dgnn_tpu_torch.graph.knn import knn_mask_neg

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    # DGCNN's layers: the mask from features of the layer's input width
    for c_in, f in EC_LAYERS:
        x = torch.randn((8, EC_P, c_in), generator=gen, device=dev)
        hs = torch.randn((8, EC_P, f), generator=gen, device=dev)
        cases.append((f"B=8 P={EC_P} F={f} knn mask of {c_in}-d features "
                      "bf16", knn_mask_neg(x, EC_K), hs))
    mask, hs = make_inputs(dev, 8, EC_P, 256, EC_K, "f32", seed=3)
    cases.append((f"B=8 P={EC_P} F=256 random mask f32 / -1e9", mask, hs))
    # no multiple of any tile; a row that admits nothing; a duplicated
    # source row that every row admits, so the first of the two must win
    mask, hs = make_inputs(dev, 3, 1000, 70, EC_K, "knn", seed=4)
    mask[0, 5] = -1e30
    hs[1, 700] = hs[1, 3]
    mask[1, :, 3] = 0
    mask[1, :, 700] = 0
    cases.append(("B=3 P=1000 F=70 knn mask bf16, an empty row, a "
                  "duplicated source row", mask, hs))
    # what the list pass must not prune by, P = 1000 and F = 70 throughout:
    # no admitted column at all to tell from the rest, any float values, a
    # neg that is small beside h_src, and the list's cap
    b, p, f = 2, 1000, 70
    hs = torch.randn((b, p, f), generator=gen, device=dev)
    cases.append((f"B={b} P={p} F={f} all-zero mask f32",
                  torch.zeros((b, p, p), device=dev), hs))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((f"B={b} P={p} F={f} random normal mask x 3 "
                      f"{str(dtype).split('.')[-1]}",
                      (torch.randn((b, p, p), generator=gen, device=dev)
                       * 3).to(dtype), hs))
    admit = torch.rand((b, p, p), generator=gen, device=dev) < EC_K / p
    cases.append((f"B={b} P={p} F={f} mask {{0, -1}} f32, h_src of scale 10",
                  torch.where(admit, 0.0, -1.0), hs * 10))
    mask = torch.where(admit, 0.0, -1e30).to(torch.bfloat16)
    mask[0, 7] = -1e30
    mask[0, 7, 5:5 + ec_tiles.LIVE_CAP + 1] = 0   # one over the list's cap
    mask[0, 8] = -1e30
    mask[0, 8, 5:5 + ec_tiles.LIVE_CAP] = 0       # at the cap: still a list
    cases.append((f"B={b} P={p} F={f} mask bf16, rows of "
                  f"{ec_tiles.LIVE_CAP + 1} and {ec_tiles.LIVE_CAP} "
                  "admitted columns (list overflow)", mask, hs))
    done = []
    for what, mask, hs in cases:
        want, want_i = ec_tiles.masked_max_plain(mask, hs, with_index=True)
        # the list pass alone against the rule in plain PyTorch
        n_live = ec_tiles.live_candidates(mask, hs).sum(
            dim=-1, dtype=torch.int32)
        want_n = torch.where(n_live > ec_tiles.LIVE_CAP, -1, n_live).to(
            torch.int32)
        got_n = ec_tiles.live_counts(mask, hs)
        err["masked_max_live_lists"] = max(
            err["masked_max_live_lists"],
            float((got_n - want_n).abs().max()))
        assert torch.equal(got_n, want_n), (what, "live counts")
        if "overflow" in what:
            assert int(got_n[0, 7]) == -1 \
                and int(got_n[0, 8]) == ec_tiles.LIVE_CAP
        if "knn" in what and "empty row" not in what:
            # the model's masks: live = admitted, no row walked densely
            assert torch.equal(got_n, (mask == 0).sum(
                dim=-1, dtype=torch.int32)), what
        n_cmp = 1
        for schedule in ec_tiles.SCHEDULES:
            name = "masked_max_" + schedule
            got = ec_tiles.masked_max(mask, hs, schedule=schedule)
            got_m, got_i = ec_tiles.masked_max(mask, hs, schedule=schedule,
                                               with_index=True)
            for g in (got, got_m):
                err[name] = max(err[name], float((g - want).abs().max()))
                assert torch.equal(g, want), (what, schedule)
            assert torch.equal(got_i, want_i), (what, schedule, "index")
            n_cmp += 2
        if "empty row" in what:
            # about neg, finite: the mask is added, not selected on
            assert bool(torch.isfinite(want[0, 5]).all()) \
                and float(want[0, 5].max()) < -1e29
            # both copies tie wherever one of them wins: the first is named
            assert int((want_i[1] == 700).sum()) == 0 \
                and int((want_i[1] == 3).sum()) > 0
        done.append((what, n_cmp))
    torch.cuda.synchronize()
    return done


def check_gathers(gather, study, dev, err):
    """gather_rows_sum and gather_lanes against their plain versions at the
    study's shapes; returns the cases as strings."""
    done = []
    for width in (32, 64, 256):
        for sub in (8, 2):
            feat, nbr = study.rows_inputs(dev, sub=sub, width=width, seed=5)
            got = gather.gather_rows_sum(feat, nbr)
            want = gather.gather_rows_sum_plain(feat, nbr)
            torch.testing.assert_close(got, want, **study.rows_tol(width))
            err["gather_rows_sum"] = max(err["gather_rows_sum"],
                                         float((got - want).abs().max()))
            done.append(f"W={width} row={sub * 128}")
            del feat, nbr, got, want
    # large tables in many column slices of 32 floats: 5200 floats a row
    # (the last slice 16), 128, and 36 (the last slice one 16-byte group)
    gen = torch.Generator(device=dev).manual_seed(12)
    for n, row, segs, width in ((4096, 5200, 40, 7), (100000, 128, 33, 40),
                                (50000, 36, 21, 70)):
        feat = torch.randn((n, row // 4, 4), generator=gen, device=dev)
        nbr = torch.randint(0, n, (segs, width), generator=gen, device=dev,
                            dtype=torch.int32)
        got = gather.gather_rows_sum(feat, nbr)
        want = gather.gather_rows_sum_plain(feat, nbr)
        torch.testing.assert_close(got, want, **study.rows_tol(width))
        err["gather_rows_sum"] = max(err["gather_rows_sum"],
                                     float((got - want).abs().max()))
        done.append(f"N={n} W={width} row={row}")
        del feat, nbr, got, want
    for c in study.LANES_CASES:
        tab, idx = study.lanes_inputs(dev, c, seed=6)
        got = gather.gather_lanes(tab, idx)
        want = gather.gather_lanes_plain(tab, idx)
        assert torch.equal(got, want), c
        done.append(f"c={c} slab={gather.lane_slab_width(c, tab.shape[1])}")
    # lane counts and widths off the kernel's grain: L no multiple of 4, a
    # width that is no multiple of the slab (the last slab overhangs), one
    # id a row, a slab of one column
    gen = torch.Generator(device=dev).manual_seed(11)
    for c, lanes, groups, rows in ((300, 6, 3, 1001), (300, 8, 3, 1001),
                                   (3000, 10, 5, 4099), (300, 1, 5, 77),
                                   (51200, 8, 1, 513)):
        tab = torch.randn((c, lanes * groups), generator=gen, device=dev)
        idx = torch.randint(0, c, (rows, lanes), generator=gen, device=dev,
                            dtype=torch.int32)
        got = gather.gather_lanes(tab, idx)
        assert torch.equal(got, gather.gather_lanes_plain(tab, idx)), \
            (c, lanes, groups)
        done.append(f"c={c} L={lanes} width={lanes * groups} "
                    f"slab={gather.lane_slab_width(c, lanes * groups)}")
    torch.cuda.synchronize()
    return done


def check_edgeconv_op(dev, rng):
    """edge_conv_max_dense on the card against the same op on CPU copies:
    forward and both gradients, both backward modes, both mul_dtypes.  The
    mask is built once, on the CPU, and copied."""
    from dgnn_tpu_torch.graph.knn import knn_mask_neg
    from dgnn_tpu_torch.ops.edgeconv import edge_conv_max_dense

    b, p, f = EC_OP_SHAPE
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, p, 3), (b, p, f), (b, p, f), (b, p, f))]
    # d h_src sums some twenty signed g per element, by atomics in another
    # order on the card: at unit-scale g its float32 rounding floor reaches
    # the stated atol where the terms cancel (as G_SCALE says of d ac)
    arrs[3] *= G_SCALE
    mask = knn_mask_neg(torch.from_numpy(arrs[0]), 20)
    done = []
    for bwd_mode in ("tie_sum", "argmax"):
        for mul_dtype, tol in ((torch.float32, EC_F32_TOL),
                               (torch.bfloat16, EC_BF16_TOL)):
            res = {}
            for where, to in (("card", dev), ("cpu", "cpu")):
                hs, hd = (torch.from_numpy(a).to(to).requires_grad_(True)
                          for a in arrs[1:3])
                out = edge_conv_max_dense(mask.to(to), hs, hd, mul_dtype,
                                          bwd_mode)
                out.backward(torch.from_numpy(arrs[3]).to(to))
                res[where] = [out.detach().cpu(), hs.grad.cpu(),
                              hd.grad.cpu()]
            assert torch.equal(res["card"][0], res["cpu"][0]), bwd_mode
            worst = 0.0
            for name, a, c in zip(("h_src", "h_dst"), res["card"][1:],
                                  res["cpu"][1:]):
                torch.testing.assert_close(
                    a, c, **tol, msg=lambda m: f"d{name} {bwd_mode}: {m}")
                worst = max(worst, float((a - c).abs().max()))
            done.append(f"{bwd_mode} mul_dtype "
                        f"{str(mul_dtype).split('.')[-1]} (max |diff| "
                        f"{worst:.3g})")
    return done


def all_launches():
    """Every wrapper's launch count, one dict."""
    from dgnn_tpu_torch import ops

    return ops.all_launches()


def reset_all_launches():
    from dgnn_tpu_torch import ops

    ops.reset_all_launches()


def tie_cases(ec_tiles, dev):
    """(description, mask, h_src) of the tie-sum backward's check: the
    model's k-NN masks at P = 1024, k = 40 and DGCNN's widths, with two
    duplicated source rows (exact ties) that every row admits; the masks
    on which a {0, neg} rule would drop pairs that hit (three values,
    neg = -8 beside h_src of scale 4, rows that admit nothing, any floats);
    a row over the masked-max lists' cap."""
    from dgnn_tpu_torch.graph.knn import knn_mask_neg

    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for f in (64, 128, 256):
        x = torch.randn((EC_TIE_B, EC_P, 3), generator=gen, device=dev)
        hs = torch.randn((EC_TIE_B, EC_P, f), generator=gen, device=dev)
        mask = knn_mask_neg(x, EC_K)
        dup = 2 * EC_P // 3
        hs[1, dup] = hs[1, 3]
        mask[1, :, 3] = 0
        mask[1, :, dup] = 0
        cases.append((f"B={EC_TIE_B} P={EC_P} F={f} knn mask bf16, a "
                      "duplicated source row every row admits", mask, hs))
    b, p, f = EC_TIE_ODD
    hs = torch.randn((b, p, f), generator=gen, device=dev)
    hs[0, 5] = hs[0, 1]
    pick = torch.rand((b, p, p), generator=gen, device=dev)
    cases.append((f"B={b} P={p} F={f} three-valued mask f32 (0, -0.5, -3)",
                  torch.where(pick < 0.3, 0.0,
                              torch.where(pick < 0.6, -0.5, -3.0)), hs))
    admit = torch.rand((b, p, p), generator=gen, device=dev) < 3 / p
    cases.append((f"B={b} P={p} F={f} mask {{0, -8}} f32, h_src of scale 4",
                  torch.where(admit, 0.0, -8.0), hs * 4))
    mask = knn_mask_neg(torch.randn((b, p, 3), generator=gen, device=dev), 5)
    mask[0, 4] = -1e30
    mask[1, 2] = -1e30
    cases.append((f"B={b} P={p} F={f} knn mask bf16, rows that admit "
                  "nothing", mask, hs))
    cases.append((f"B={b} P={p} F={f} random normal mask x 2 f32",
                  torch.randn((b, p, p), generator=gen, device=dev) * 2, hs))
    mask = knn_mask_neg(torch.randn((b, p, 3), generator=gen, device=dev), 5)
    mask[0, 7] = -1e30
    mask[0, 7, 3:3 + ec_tiles.LIVE_CAP + 1] = 0
    cases.append((f"B={b} P={p} F={f} knn mask bf16, a row of "
                  f"{ec_tiles.LIVE_CAP + 1} admitted columns (over the "
                  "lists' cap)", mask, hs))
    b, p, f = EC_TIE_LONG
    hs = torch.randn((b, p, f), generator=gen, device=dev)
    mask = knn_mask_neg(torch.randn((b, p, 3), generator=gen, device=dev),
                        EC_K)
    mask[1, :, 7] = 0
    hs[1, 7] += 4  # the column passes every row's filter: walked densely
    hs[0, p - 1] = hs[0, 2]
    cases.append((f"B={b} P={p} F={f} knn mask bf16 past the sum's "
                  "1024-row chunk, a column every row admits and passes",
                  mask, hs))
    return cases


def check_tie_lists(edgeconv, m, mask, hs, cpu, what):
    """The tie-sum list pass on the card against tie_lists_plain on CPU
    copies: the counts, and each list's entries up to its count or the
    cap, exactly.  Returns (columns over the cap, largest count)."""
    _, entries, count = edgeconv._tie_lists(m, mask, hs)
    want_entries, want_count = edgeconv.tie_lists_plain(cpu[0], cpu[1],
                                                        cpu[2])
    count = count.cpu()
    assert torch.equal(count, want_count), (what, "list counts")
    slot = torch.arange(edgeconv.TIE_CAP)
    used = slot < count.clamp(max=edgeconv.TIE_CAP)[..., None]
    assert torch.equal(entries.cpu()[used], want_entries[used]), \
        (what, "list entries")
    return int((count > edgeconv.TIE_CAP).sum()), int(count.max())


def check_tie_sum(ec_tiles, edgeconv, dev, err):
    """tie_sum_bwd against its plain version (_dsrc_ties) on CPU copies of
    the same inputs (m from the card's masked max), in both mul_dtypes:
    equal bit for bit (the same pairs summed in the same order), and two
    calls on the same inputs too; one list pass and one sum a call; the
    list pass alone equal to tie_lists_plain.  Returns the cases as
    strings."""
    done = []
    for what, mask, hs in tie_cases(ec_tiles, dev):
        gen = torch.Generator(device=dev).manual_seed(14)
        g = torch.randn(hs.shape, generator=gen, device=dev) * G_SCALE
        m = ec_tiles.masked_max(mask, hs, schedule=edgeconv.SCHEDULE)
        cpu = [t.cpu() for t in (m, mask, hs, g)]
        over, largest = check_tie_lists(edgeconv, m, mask, hs, cpu, what)
        worst = []
        for mul_dtype, tol in ((torch.float32, EC_F32_TOL),
                               (torch.bfloat16, EC_BF16_TOL)):
            before = dict(edgeconv.LAUNCHES)
            got = edgeconv.tie_sum_bwd(m, mask, hs, g, mul_dtype)
            again = edgeconv.tie_sum_bwd(m, mask, hs, g, mul_dtype)
            torch.cuda.synchronize()
            assert edgeconv.LAUNCHES == {k: v + 2 for k, v in
                                         before.items()}, what
            assert torch.equal(got, again), (what, "two calls differ")
            want = edgeconv._dsrc_ties(*cpu, mul_dtype)
            got = got.cpu()
            torch.testing.assert_close(
                got, want, **tol,
                msg=lambda msg_: f"tie_sum_bwd {what} {mul_dtype}: {msg_}")
            diff = float((got - want).abs().max())
            assert diff == 0, (what, mul_dtype, diff)
            err["tie_sum_bwd"] = max(err["tie_sum_bwd"], diff)
            worst.append(f"{str(mul_dtype).split('.')[-1]} {diff:.3g}")
        done.append(f"{what} ({over} columns over the lists' cap of "
                    f"{edgeconv.TIE_CAP}, the largest count {largest}): max "
                    "|diff| " + ", ".join(worst))
        del mask, hs, g, m, cpu
    return done


def run_edgeconv_trainer(trainer):
    """DGCNN at full width through the trainer's entry point (2 epochs: the
    timing on a copy, 2 run_epochs replays, inference timed by the loop),
    with every launch count set to 0 just before and read just after."""
    args = trainer.parser().parse_args(["--num-epochs", "2", "--device",
                                        "cuda"])
    assert (args.batch_size, args.num_points, args.k) == (EC_B, EC_P, EC_K)
    reset_all_launches()
    r = trainer.run(args)
    launches = all_launches()
    losses = r["losses"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    model = r["model"]
    assert [(c.theta.in_features, c.theta.out_features)
            for c in model.convs.values()] == list(EC_LAYERS)
    # the steps and test batches the card ran (counted there: the timing
    # loops' warmups and replays, the run_epochs replays); a replay's
    # launches count as the wrappers' counts do
    want = dict.fromkeys(launches, 0)  # every other kernel: none
    want["masked_max_step8"] = want["masked_max_live_lists"] = (
        (r["train_steps"] + r["eval_batches"]) * len(model.convs))
    want["tie_sum_bwd"] = want["tie_sum_lists"] = (r["train_steps"]
                                                   * len(model.convs))
    assert launches == want, (launches, want)
    # the trained model on two test clouds: the card against a CPU copy
    x = r["x_test"][:2]
    model.eval()
    model_cpu = copy.deepcopy(model).to("cpu").eval()
    masks, masks_cpu = [], []
    with torch.no_grad():
        got = model(x, masks_out=masks).cpu()
        model_cpu(x.cpu(), masks_out=masks_cpu)
        # the masks first, layer by layer, so that a failure says where
        flips = [int((a.cpu() != c).sum()) for a, c in zip(masks, masks_cpu)]
        for i, n in enumerate(flips):
            assert n <= EC_MASK_FLIPS * masks[i].numel(), (i, flips)
        want_logits = model_cpu(x.cpu(), masks=[m.cpu() for m in masks])
    torch.testing.assert_close(got, want_logits, **EC_LOGIT_TOL)
    r["logit_err"] = float((got - want_logits).abs().max())
    r["mask_flips"] = flips
    return r, launches


# wrapper names per trainer: bin forward, bin backward, dense forward, dense
# backward
PATH_KERNELS = {
    "gat": ("bin_gat_fwd", "bin_gat_bwd", "dense_gat_fwd", "dense_gat_bwd"),
    "gmm": ("bin_gmm_node_fwd", "bin_gmm_node_bwd", "dense_gmm_fwd",
            "dense_gmm_bwd"),
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_launches(bins, model_kind, r, launches, steps, forwards):
    """The launch counts (every key of ``launches``) that ``steps`` training
    steps and ``forwards`` more forwards of a trainer run ``r``'s model on
    its graph imply: each bin kernel one launch a call for every bin of the
    direction (the list wrappers), the dense kernels where the graph has a
    hub block, under the instance the gathered rows' type selects; none
    for a binned-pseudo MoNet or the naive GAT (plain PyTorch passes), and
    none of the other model's."""
    g = r["graph"]
    fwd_calls = (steps + forwards) * len(r["model"].convs)
    bwd_calls = steps * len(r["model"].convs)
    bin_fwd, bin_bwd, dense_fwd, dense_bwd = PATH_KERNELS[model_kind]
    bf16 = r["gather_dtype"] == "bfloat16"
    want = dict.fromkeys(launches, 0)
    if (r.get("impl", "fused") == "fused"
            and r.get("pseudo_mode", "node") == "node"):
        want.update({
            bins.launch_name(bin_fwd, bf16):
                fwd_calls * list_launches(bins, g.fwd),
            bins.launch_name(bin_bwd, bf16):
                bwd_calls * list_launches(bins, g.bwd),
            dense_fwd: fwd_calls * (g.fwd.dense is not None),
            dense_bwd: bwd_calls * (g.bwd.dense is not None)})
        if model_kind == "gmm":  # a merge after each launch on a work list
            from dgnn_tpu_torch.ops.dense import gmm_work

            want["dense_gmm_merge"] = sum(
                calls * (a.dense is not None and gmm_work(a.dense) is not None)
                for calls, a in ((fwd_calls, g.fwd), (bwd_calls, g.bwd)))
    return want


def run_trainer(bins, trainer, model_kind, dataset, argv=None, steps=20,
                cpu_copy=True):
    """``steps`` steps through the trainer's entry point, at the bench width
    (its BENCH_ARGV) unless ``argv`` says otherwise, with every launch count
    set to 0 just before and read just after.  The launches must be exactly
    what the steps, evals, layers, bins and hub blocks imply, under the
    instance the gathered rows' type selects (a binned-pseudo MoNet and
    the naive GAT launch none: their passes are plain PyTorch).  With ``cpu_copy`` the
    loss must fall and the trained model's logits must match a CPU copy's;
    else they must be finite."""
    args = trainer.parser().parse_args(
        ["--dataset", dataset,
         *(trainer.BENCH_ARGV if argv is None else argv),
         "--n-epochs", str(steps), "--device", "cuda"])
    reset_all_launches()
    r = trainer.run(args)
    launches = all_launches()
    losses = r["losses"]
    assert all(np.isfinite(losses)), losses
    g = r["graph"]
    # the steps and forwards the card ran (the trainer counts them there:
    # the timing loops' warmups and replays, the run_epochs replays, the
    # last forward); a replay's launches count as the wrappers' counts do
    want = path_launches(bins, model_kind, r, launches, r["train_steps"],
                         r["infer_calls"])
    assert launches == want, (launches, want)
    fused = r.get("impl", "fused") == "fused"
    if not cpu_copy:
        assert bool(torch.isfinite(r["logits"]).all())
        return r, launches
    assert losses[-1] < losses[0], losses
    model_cpu = copy.deepcopy(r["model"]).to("cpu").eval()
    extra = [trainer._to(r["pseudo"], "cpu")] if "pseudo" in r else []
    with torch.no_grad():
        logits_cpu = model_cpu(g.to("cpu"), r["feats"].cpu(), *extra)
    got = r["logits"].cpu()
    tol = dict(rtol=1e-4, atol=1e-4)
    r["logit_off"] = int((~torch.isclose(got, logits_cpu, **tol)).sum())
    r["logit_err"] = float((got - logits_cpu).abs().max())
    if fused and g.fwd.dense is not None:
        # bf16 hub-block products: the card's and the CPU's projection
        # matmuls (float32, another order) and exp differ by ulps, which
        # moves some operands across a bf16 rounding boundary; each such
        # term moves by 2^-8 of itself, and two layers spread it to the
        # neighbouring rows.  So the logits are held to BF16_BOUND.
        tol = BF16_BOUND
    torch.testing.assert_close(got, logits_cpu, **tol)
    return r, launches


# ---------------------------------------------------------------------------
# phase "loop": the device-resident epoch loop (utils/timing.py), a step
# captured into a CUDA graph and replayed, against the same steps issued
# from the host


def loop_side(trainer, kind, r, args, dev, losses=True):
    """A copy of trainer run ``r``'s model with a fresh optimizer and the
    trainer's generators seeded as ``args`` seeds them, and the trainer's
    own step over them (``make_step``; its losses into a buffer of
    LOOP_STEPS where ``losses``)."""
    from dgnn_tpu_torch.utils import make_optimizer

    model = copy.deepcopy(r["model"])
    opt = make_optimizer(model, args.lr, args.weight_decay)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    buf = torch.zeros(LOOP_STEPS, device=dev) if losses else None
    if kind == "gat":
        gens = trainer.generators(args.seed, dev)
        step = trainer.make_step(model, opt, r["graph"], r["feats"],
                                 r["labels"], r["train_mask"], gens, count,
                                 buf)
    else:
        gens = (torch.Generator(device=dev).manual_seed(args.seed),)
        step = trainer.make_step(model, opt, r["graph"], r["feats"],
                                 r["pseudo"], r["labels"], r["train_mask"],
                                 gens[0], count, buf)
    return dict(model=model, gens=gens, step=step, losses=buf)


@contextlib.contextmanager
def logged_seeds(trainer, log):
    """The attention seeds the GAT trainer's steps draw, copied on the card
    into the rows of ``log`` in turn (a row a step, replays included)."""
    draw = trainer.draw_seeds
    at = torch.zeros(1, dtype=torch.int64, device=log.device)

    def logged(n, gen):
        seeds = draw(n, gen)
        log.index_copy_(0, at, seeds[None])
        at.add_(1)
        return seeds

    trainer.draw_seeds = logged
    try:
        yield
    finally:
        trainer.draw_seeds = draw


def step_ms(trainer, kind, r, args, dev, steps):
    """Ms a training step of trainer run ``r``'s model, issued from the
    host and replayed from a CUDA graph (utils.timing.StepGraph, after the
    same warmup), each on its own copy of the state; CUDA events around
    ``steps`` steps."""
    from dgnn_tpu_torch.utils import StepGraph, time_calls

    eager = loop_side(trainer, kind, r, args, dev, losses=False)
    eager_ms = time_calls(eager["step"], dev, iters=steps, warmup=3) * 1e3
    del eager
    side = loop_side(trainer, kind, r, args, dev, losses=False)
    graph = StepGraph(side["step"], dev, generators=side["gens"], warmup=3)
    try:
        graph.replay(1)
        replay_ms = graph.seconds(steps) / steps * 1e3
    finally:
        graph.close()
    return eager_ms, replay_ms


def run_loop(bins, trainer, kind, dataset, r, dev, smi):
    """Phase loop on one trainer run ``r`` (its graph and model at the bench
    width): LOOP_STEPS steps of the trainer's step issued from the host
    against LOOP_STEPS replays of ``run_epochs`` (one capture), from the
    same state and generator states.  The losses and every parameter
    within LOOP_TOL (atol scaled to each tensor's largest element), the
    GAT's attention seeds the same on both sides and different from one
    step to the next, the launches exactly 2 LOOP_STEPS steps' (a replay
    counts its step's); then eager against replayed ms a step."""
    from dgnn_tpu_torch.utils import run_epochs

    args = trainer.parser().parse_args(["--dataset", dataset,
                                        *trainer.BENCH_ARGV])
    n_convs = len(r["model"].convs)
    reset_all_launches()
    sides, logs = [], []
    for replayed in (False, True):
        side = loop_side(trainer, kind, r, args, dev)
        log = torch.zeros((LOOP_STEPS, n_convs), dtype=torch.int32,
                          device=dev)
        with (logged_seeds(trainer, log) if kind == "gat"
              else contextlib.nullcontext()):
            if replayed:
                run_epochs(side["step"], LOOP_STEPS, device=dev,
                           generators=side["gens"])
            else:
                for _ in range(LOOP_STEPS):
                    side["step"]()
        sides.append(side)
        logs.append(log)
    torch.cuda.synchronize()
    launches = all_launches()
    want = path_launches(bins, kind, r, launches, 2 * LOOP_STEPS, 0)
    assert launches == want, (kind, dataset, launches, want)
    eager, replay = sides
    pairs = [("loss", eager["losses"], replay["losses"])] + [
        (name, a.detach(), b.detach()) for (name, a), (_, b) in zip(
            eager["model"].named_parameters(),
            replay["model"].named_parameters())]
    worst, bit_equal = 0.0, True
    for name, a, b in pairs:
        atol = LOOP_TOL["atol_scale"] * float(a.abs().max())
        torch.testing.assert_close(
            b, a, rtol=LOOP_TOL["rtol"], atol=atol,
            msg=lambda m, name=name: f"{kind} {dataset} {name}: {m}")
        bit_equal &= torch.equal(a, b)
        worst = max(worst, float((a - b).abs().max()))
    seeds = ""
    if kind == "gat":
        assert torch.equal(logs[0], logs[1]), (logs[0], logs[1])
        step_to_step = (logs[1][1:] != logs[1][:-1]).any(dim=1)
        assert bool(step_to_step.all()), logs[1]
        seeds = (f"; the {LOOP_STEPS} replays drew the eager steps' "
                 f"attention seeds, each step's differing from the last's")
    losses = eager["losses"].tolist()
    used = {k: v for k, v in launches.items() if v}
    del sides, eager, replay
    eager_ms, replay_ms = step_ms(trainer, kind, r, args, dev, LOOP_TIME_STEPS)
    phase("loop", f"{dataset} {kind}: {LOOP_STEPS} run_epochs replays = "
          f"{LOOP_STEPS} eager steps from the same state (loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; losses and {len(pairs) - 1} "
          f"parameters within rtol {LOOP_TOL['rtol']}, atol "
          f"{LOOP_TOL['atol_scale']} x each tensor's largest element; max "
          f"|diff| {worst:.3g}; bit-equal {bit_equal}){seeds}; launches "
          f"{used} = 2 x {LOOP_STEPS} steps'; ms a step: eager "
          f"{eager_ms:.4f}, replayed {replay_ms:.4f} ({LOOP_TIME_STEPS} "
          f"steps each, CUDA events) | {smi}")
    return dict(eager_ms=eager_ms, replay_ms=replay_ms, bit_equal=bit_equal,
                max_diff=worst)


def ec_loop_side(trainer, r, dev, epochs, losses=True):
    """A copy of DGCNN trainer run ``r``'s model with a fresh optimizer
    (its cosine over ``epochs`` epochs) and a generator seeded as the
    trainer seeds its own, and the trainer's epoch over them (``make_epoch``;
    its losses into a buffer where ``losses``)."""
    from dgnn_tpu_torch.utils import make_sgd_cosine

    spe = r["steps_per_epoch"]
    model = copy.deepcopy(r["model"])
    gen = torch.Generator(device=dev).manual_seed(0)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    buf = torch.zeros(epochs * spe, device=dev) if losses else None
    epoch = trainer.make_epoch(model, make_sgd_cosine(model, epochs * spe),
                               r["x_train"], r["y_train"], EC_B, gen, count,
                               torch.zeros(2, device=dev), buf)
    return dict(model=model, gens=(gen,), epoch=epoch, losses=buf)


def run_edgeconv_loop(trainer, r, dev, smi):
    """Phase loop on the DGCNN trainer run ``r`` (its clouds and model at
    full width): EC_LOOP_EPOCHS epochs of the trainer's epoch issued from
    the host against EC_LOOP_EPOCHS replays of ``run_epochs`` (one capture
    of the epoch: its shuffle, augmentation and steps), from the same state
    and generator state.  The losses, every parameter and BatchNorm buffer
    within LOOP_TOL; the launches exactly 2 x EC_LOOP_EPOCHS epochs'; then
    eager against replayed ms an epoch."""
    from dgnn_tpu_torch.utils import StepGraph, run_epochs, time_calls

    spe, n_convs = r["steps_per_epoch"], len(r["model"].convs)
    reset_all_launches()
    sides = []
    for replayed in (False, True):
        side = ec_loop_side(trainer, r, dev, EC_LOOP_EPOCHS)
        if replayed:
            run_epochs(side["epoch"], EC_LOOP_EPOCHS, device=dev,
                       generators=side["gens"])
        else:
            for _ in range(EC_LOOP_EPOCHS):
                side["epoch"]()
        sides.append(side)
    torch.cuda.synchronize()
    launches = all_launches()
    steps = 2 * EC_LOOP_EPOCHS * spe
    want = dict.fromkeys(launches, 0)
    want["masked_max_step8"] = want["masked_max_live_lists"] = \
        want["tie_sum_bwd"] = want["tie_sum_lists"] = steps * n_convs
    assert launches == want, ("edgeconv loop", launches, want)
    eager, replay = sides
    pairs = [("loss", eager["losses"], replay["losses"])] + [
        (name, a.detach(), b.detach()) for (name, a), (_, b) in zip(
            eager["model"].state_dict().items(),
            replay["model"].state_dict().items())]
    worst, bit_equal = 0.0, True
    for name, a, b in pairs:
        atol = LOOP_TOL["atol_scale"] * float(a.abs().max())
        torch.testing.assert_close(
            b, a, rtol=LOOP_TOL["rtol"], atol=atol,
            msg=lambda m, name=name: f"edgeconv modelnet {name}: {m}")
        bit_equal &= torch.equal(a, b)
        worst = max(worst, float((a - b).abs().max()))
    losses = eager["losses"].tolist()
    used = {k: v for k, v in launches.items() if v}
    del sides, eager, replay
    # eager against replayed ms an epoch, each on its own copy of the state
    side = ec_loop_side(trainer, r, dev, 3 + EC_LOOP_TIME_EPOCHS, False)
    eager_ms = time_calls(side["epoch"], dev, iters=EC_LOOP_TIME_EPOCHS,
                          warmup=1) * 1e3
    side = ec_loop_side(trainer, r, dev, 3 + EC_LOOP_TIME_EPOCHS, False)
    graph = StepGraph(side["epoch"], dev, generators=side["gens"], warmup=1)
    try:
        graph.replay(1)
        replay_ms = graph.seconds(EC_LOOP_TIME_EPOCHS) / \
            EC_LOOP_TIME_EPOCHS * 1e3
    finally:
        graph.close()
    del side
    phase("loop", f"modelnet DGCNN: {EC_LOOP_EPOCHS} run_epochs replays of "
          f"the trainer's epoch ({spe} steps, its shuffle and augmentation "
          f"drawn on the card) = {EC_LOOP_EPOCHS} eager epochs from the same "
          f"state (loss {losses[0]:.4f} -> {losses[-1]:.4f}; losses and "
          f"{len(pairs) - 1} parameters and BatchNorm buffers within rtol "
          f"{LOOP_TOL['rtol']}, atol {LOOP_TOL['atol_scale']} x each "
          f"tensor's largest element; max |diff| {worst:.3g}; bit-equal "
          f"{bit_equal}); launches {used} = 2 x {EC_LOOP_EPOCHS} epochs'; ms "
          f"an epoch: eager {eager_ms:.4f}, replayed {replay_ms:.4f} "
          f"({EC_LOOP_TIME_EPOCHS} epochs each, CUDA events; a step "
          f"{eager_ms / spe:.4f} / {replay_ms / spe:.4f}) | {smi}")
    return dict(eager_ms=eager_ms, replay_ms=replay_ms, bit_equal=bit_equal,
                max_diff=worst)


def block_row_edges(db, chunk=512):
    """Edges of each row of a hub block (its set mask bits over every tile
    of the row), counted on the card a few hundred tiles at a time (a
    reddit block's masks are hundreds of MB)."""
    dev = db.mask.device
    pop = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int64, device=dev)
    rt = db.mask.shape[1]
    rows = torch.zeros(db.row_ids.shape[0], dtype=torch.int64, device=dev)
    lane = torch.arange(rt, device=dev)
    for t0 in range(0, db.mask.shape[0], chunk):
        per = pop[db.mask[t0:t0 + chunk].long()].sum(dim=-1)  # [c, RT]
        idx = db.rc[t0:t0 + chunk].long()[:, None] * rt + lane
        rows.index_add_(0, idx.flatten(), per.flatten())
    return rows


def hub_line(graph):
    """Tiles, edges and widest row of each direction's hub block."""
    out = []
    for name, adj in (("fwd", graph.fwd), ("bwd", graph.bwd)):
        db = adj.dense
        if db is None:
            out.append(f"{name} no hub block")
            continue
        rows = block_row_edges(db)
        out.append(f"{name} {db.mask.shape[0]} tiles, {db.num_rows} rows x "
                   f"{db.col_ids.shape[0]} columns, {int(rows.sum())} edges, "
                   f"widest row {int(rows.max())} edges")
    return "; ".join(out)


def reddit_tables(kind, n, a, f, dev):
    """Random tables of one layer of ``kind`` at (heads or Gaussian kernels,
    F) on n nodes, made on the card (a CPU pass at reddit's size would not
    fit): the keys of ``tables`` or ``gmm_tables``, the feature rows
    rounded to bf16 (the values the model gathers), M, Linv and the inverse
    widths in the ranges the forward gives."""
    gen = torch.Generator(device=dev).manual_seed(4)

    def t(*shape, lo=None, scale=1.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x if lo is None else x.abs() + lo

    rows = dict(feat=t(n, a, f), g=t(n, a, f, scale=G_SCALE))
    rows = {k: v.to(torch.bfloat16).float() for k, v in rows.items()}
    if kind == "gat":
        return dict(rows, ac=t(n, a), ar=t(n, a), M=t(n, a, lo=2.0),
                    Linv=t(n, a, lo=0.01), ws=t(n, a))
    return dict(rows, alpha=t(n, GMM_D), beta=t(n, GMM_D), sfeat=t(n, 1),
                dfeat=t(n, 1), mu=t(a, GMM_D), isig=t(a, GMM_D, lo=0.5))


def reddit_kernel_times(bins, dense, kind, graph, shapes, dev, time_calls):
    """Each kernel of one model's reddit path at each layer's width, called
    as the ops call it (``path_jobs`` with bf16 feature rows) on random
    tables: (name, shape) -> dict(ms, bound_ms, bound_by, edges).  Times
    from CUDA events over 3 calls after one warmup; no plain version (it
    would not fit at this size)."""
    out = {}
    for a, f in shapes:
        tb = reddit_tables(kind, graph.num_nodes, a, f, dev)
        for name, (fn, _plain, inputs, edges) in path_jobs(
                bins, dense, kind, graph, tb, torch.bfloat16).items():
            ms = time_calls(fn, dev, iters=3, warmup=1) * 1e3
            bound_ms, bound_by = bound(name, inputs, flat(fn()), edges,
                                       a * f, a)
            out[(name, (a, f))] = dict(ms=ms, bound_ms=bound_ms,
                                       bound_by=bound_by, edges=edges)
        del tb
        torch.cuda.empty_cache()
    return out


def run_reddit(bins, dense, trainers, titles, launches, scale, dev, smi):
    """The reddit phase: GAT and MoNet at the JAX bench's reddit widths
    (bf16 feature gathers) through their trainers' entry points on the
    R-MAT graph at ``scale`` of reddit's size, built on the host (GAT's run,
    through the native graph library: asserted) and cached in a fresh
    directory as the trainers do (MoNet's run reads it), launches into
    ``launches``; then each kernel of the path on that graph at both
    layers' widths, timed beside its bound."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:
        rmat_s = _run_reddit(bins, dense, trainers, titles, launches, scale,
                             dev, smi, cache)
        t0 = time.perf_counter()
        run_memory(cache, dev, smi)
        phase("memory", f"the memory phase took "
              f"{time.perf_counter() - t0:.1f} s (the cut scales' host "
              "builds included)")
    return rmat_s


def _run_reddit(bins, dense, trainers, titles, launches, scale, dev, smi,
                cache):
    from dgnn_tpu_torch import native
    from dgnn_tpu_torch.data.reddit import reddit_size
    from dgnn_tpu_torch.utils import time_calls

    n, e = reddit_size(scale)
    cut = "" if scale == 1 else (f" (cut from 232965 nodes, 114615892 "
                                 f"edges: nodes and edges x {scale})")
    argv = {"gat": trainers["gat"].BENCH_ARGV + ["--gather-dtype",
                                                 "bfloat16"],
            "gmm": trainers["gmm"].BENCH_ARGV + ["--n-kernels", "2"]}
    shapes = {"gat": REDDIT_SHAPES, "gmm": ((2, 64), (2, 41))}
    titles = dict(titles, gmm="MoNet hidden 64 kernels 2 dim 2 dropout 0.5 "
                  "lr 1e-2")
    rmat_s = None
    for kind in ("gat", "gmm"):
        native.reset_calls()
        r, launches[(kind, "reddit")] = run_trainer(
            bins, trainers[kind], kind, "reddit",
            argv=argv[kind] + ["--scale", str(scale), "--cache-dir", cache],
            steps=REDDIT_STEPS, cpu_copy=False)
        calls = dict(native.CALLS)
        g = r["graph"]
        if kind == "gat":  # the host build: every stage in the library,
            # one bin fill a bin of each direction that kept edges
            rmat_s = r["setup_s"]["rmat edges"]
            assert calls == dict(
                coo_to_csr=1, csr_to_csc_permute=1, dense_mask_fill=2,
                rmat_edges=0, tile_row_edges=0,
                bin_fill=sum(len(a.widths) for a in (g.fwd, g.bwd)
                             if a.num_edges)), calls
        else:  # read from the cache GAT's run wrote; the blocks' tile rows
            # counted at their first MoNet launch (the work lists)
            assert calls.pop("tile_row_edges") == 2, calls
            assert not any(calls.values()), calls
            assert "cache load" in r["setup_s"], r["setup_s"]
        assert r["logits"].shape == (n, 41), r["logits"].shape
        assert g.fwd.dense is not None and g.bwd.dense is not None
        used = {k: v for k, v in launches[(kind, "reddit")].items() if v}
        setup = ", ".join(f"{k} {v:.1f} s" for k, v in r["setup_s"].items())
        phase("reddit", f"scale {scale}: {n} nodes, {e} edges{cut}; "
              f"{titles[kind]}, bf16 gathers: {r['train_steps']} steps, "
              f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, train "
              f"{r['train_s'] * 1e3:.3f} ms/step, inference "
              f"{r['infer_s'] * 1e3:.3f} ms, peak {r['peak_mb']:.0f} MB, test "
              f"acc {r['test_acc']:.4f}, launches {used} (every other kernel "
              f"0); host set-up {setup}, host peak RSS "
              f"{r['host_peak_mb']:.0f} MB; native graph library calls "
              f"{calls}; bins fwd {g.fwd.widths} bwd "
              f"{g.bwd.widths}; hub block {hub_line(g)} | {smi}")
        eager_ms, replay_ms = step_ms(
            trainers[kind], kind, r, trainers[kind].parser().parse_args(
                ["--dataset", "reddit", *argv[kind]]), dev, REDDIT_STEPS)
        phase("reddit", f"{kind} scale {scale}: ms a training step, eager "
              f"{eager_ms:.3f}, replayed from a CUDA graph {replay_ms:.3f} "
              f"({REDDIT_STEPS} steps each, CUDA events) | {smi}")
        steps_ = r["train_steps"] + r["infer_calls"]
        kt = reddit_kernel_times(bins, dense, kind, g, shapes[kind], dev,
                                 time_calls)
        if kind == "gat":
            far, n_cmp, worst = check_far_rows(dense, g, dev)
            phase("reddit", f"K5's far rows at scale {scale}: {far} of "
                  f"{g.fwd.dense.num_rows} block rows over "
                  f"{dense.BOUND_GAP} under the bound; {n_cmp} kernel/plain "
                  f"comparisons agree, m bit for bit, means within "
                  f"{worst:.3g} of the largest |x|")
        for (name, sh), v in kt.items():
            per_step = launches[(kind, "reddit")].get(name, 0) / steps_
            phase("reddit", f"{name} scale {scale} layer {sh}: "
                  f"{v['ms']:.4f} ms a call, bound {v['bound_ms']:.5f} ms by "
                  f"{v['bound_by']} ({v['edges']} edges; "
                  f"{v['ms'] / v['bound_ms']:.1f} times it), "
                  f"{per_step:.2f} launches a step or inference | {smi}")
        del r, g
        torch.cuda.empty_cache()
    return rmat_s


# ---------------------------------------------------------------------------
# phase "memory": scripts/memory_report_torch.py, the fused against the naive
# GAT training step's peak device memory at reddit's size

def run_memory(cache, dev, smi):
    """The report's rows on the reddit graphs under ``cache`` (scale 1 read
    from the reddit phase's cache, the cut scales built there): fused
    float32 and bf16 at scale 1, naive and fused at each cut scale that
    fits, naive's fit at scale 1 and its counted bytes.  Each row's
    launches are checked by the report (exactly what the step's layers and
    bins imply; none for the naive step); here, that the fused rows ran
    the four GAT kernels, the losses are finite, the fused step's peak is
    below the naive step's at every cut scale, every measured peak holds
    the row's counted saved bytes, and the fit is within FIT_RESIDUAL."""
    report = load_script("memory_report_torch")
    res = report.run(dev, cache, log=lambda m: phase("memory", f"{m} | {smi}"))
    rows = res["rows"]
    for r in rows:
        assert all(np.isfinite(r["losses"])), r
        assert r["peak_mb"] >= r["saved"]["total"] / report.MB, r
        assert r["peak_mb"] >= r["resident_mb"] > 0, r
        if r["impl"] == "naive":
            assert not r["launches"], r
            continue
        bf16 = "_bf16" if r["gather_dtype"] == "bfloat16" else ""
        want = {"bin_gat_fwd" + bf16, "bin_gat_bwd" + bf16}
        if r["scale"] == 1.0:  # reddit's hub blocks, both directions
            want |= {"dense_gat_fwd", "dense_gat_bwd"}
        assert want <= set(r["launches"]) <= want | {"dense_gat_fwd",
                                                     "dense_gat_bwd"}, r
    cut = sorted({r["scale"] for r in rows if r["scale"] < 1.0})
    assert len(cut) >= 3, cut
    for scale in cut:
        peak = {r["impl"]: r["peak_mb"] for r in rows if r["scale"] == scale}
        assert peak["fused"] < peak["naive"], (scale, peak)
    assert {(r["gather_dtype"], r["impl"]) for r in rows
            if r["scale"] == 1.0} == {("float32", "fused"),
                                      ("bfloat16", "fused")}
    fit = res["fit"]
    assert fit["max_rel_residual"] <= FIT_RESIDUAL, fit
    phase("memory", f"naive fitted at scale 1: {fit['at_one']:,.1f} MB "
          f"(a {fit['a']:,.1f} + b {fit['b']:,.1f} x scale over scales "
          f"{cut}, largest relative residual {fit['max_rel_residual']:.4f} <= "
          f"{FIT_RESIDUAL}); counted saved bytes at scale 1 (extrapolated, "
          f"a lower bound) {res['counted_mb']:,.1f} MB; fused float32 / bf16 "
          "at scale 1 measured peak "
          + " / ".join(f"{r['peak_mb']:,.1f}" for r in rows
                       if r["scale"] == 1.0)
          + f" MB; card {res['total_mb']:,.0f} MB | {smi}")


# ---------------------------------------------------------------------------
# phase "baselines": the native graph library, the flat primitives, the
# naive baselines, checkpoints
# ---------------------------------------------------------------------------


def graph_arrays(g):
    """Every array of a Graph, by name (None where a layout has none)."""
    out = {k: getattr(g, k) for k in ("row_ptr", "col_ind", "col_ptr",
                                      "row_ind", "permute")}
    for name in ("fwd", "bwd"):
        a = getattr(g, name)
        for key in ("nbr", "edge", "row", "count"):
            for i, t in enumerate(getattr(a, key)):
                out[f"{name}.{key}{i}"] = t
        for key in ("main", "ov_rows", "ov"):
            out[f"{name}.cmb.{key}"] = getattr(a.cmb, key)
        out[f"{name}.epos"] = a.epos
        if a.dense is not None:
            for key in ("row_ids", "col_ids", "mask", "rc", "ct", "first",
                        "chunk_ptr"):
                out[f"{name}.dense.{key}"] = getattr(a.dense, key)
    return out


def check_native(structure, native, src, dst, n, dense):
    """The host build through the native library (every function it calls
    counted) and through the numpy versions (DGNN_TPU_NATIVE=0): every
    array equal.  Returns (calls, native s, numpy s, arrays compared)."""
    native.reset_calls()
    t0 = time.perf_counter()
    got = structure.build_graph(src, dst, n, dense=dense, edge_tables=True)
    t_native = time.perf_counter() - t0
    calls = dict(native.CALLS)
    assert calls["coo_to_csr"] == calls["csr_to_csc_permute"] == 1, calls
    assert calls["bin_fill"] >= 2, calls
    assert calls["dense_mask_fill"] == (0 if dense is None else 2), calls
    os.environ["DGNN_TPU_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        want = structure.build_graph(src, dst, n, dense=dense,
                                     edge_tables=True)
        t_numpy = time.perf_counter() - t0
    finally:
        del os.environ["DGNN_TPU_NATIVE"]
    assert native.CALLS == calls  # the numpy versions only
    a, b = graph_arrays(got), graph_arrays(want)
    assert a.keys() == b.keys()
    for key in a:
        if b[key] is None:
            assert a[key] is None, key
            continue
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), \
            key
    return calls, t_native, t_numpy, sum(v is not None for v in a.values())


def on_both(fn, arrs, dev):
    """fn(*tensors) forward and backward on the card and on the CPU, the
    same float32 inputs; the last array is the output gradient.  Returns
    {"card" | "cpu": [out, grads...]} on the CPU."""
    res = {}
    for where, to in (("card", dev), ("cpu", "cpu")):
        ins = [torch.from_numpy(a).to(to).requires_grad_(True)
               for a in arrs[:-1]]
        out = fn(to, *ins)
        out.backward(torch.from_numpy(arrs[-1]).to(to))
        res[where] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
    return res


def hold_both(res, tols, what):
    """Card against CPU: the output at FWD_TOL, each gradient at its
    tolerance; returns the largest difference."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(res["card"], res["cpu"])):
        tol = FWD_TOL if i == 0 else tols[i - 1]
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{what} "
                                   f"{'out' if i == 0 else f'grad {i}'}: {m}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def check_primitives(pub_flat, rng, dev):
    """spmm, sddmm, edge_softmax and edge_transpose on the card against the
    same functions on CPU copies, forward and every gradient, at
    (H, F) = (4, 64): tests/test_primitives.py's tolerances."""
    from dgnn_tpu_torch.ops import edge_softmax, edge_transpose, sddmm, spmm

    h, f = 4, 64
    n, e = pub_flat.num_nodes, pub_flat.num_edges
    graphs = {dev: pub_flat.to(dev), "cpu": pub_flat}

    def arrays(*shapes):
        return [rng.normal(size=s).astype(np.float32) for s in shapes]

    out = {}
    out["spmm"] = hold_both(on_both(
        lambda to, w, x: spmm(graphs[to], w, x),
        arrays((e, h), (n, h, f), (n, h, f)), dev), (BWD_TOL, BWD_TOL),
        "spmm")
    out["sddmm"] = hold_both(on_both(
        lambda to, a, b: sddmm(graphs[to], a, b),
        arrays((n, h, f), (n, h, f), (e, h)), dev), (BWD_TOL, BWD_TOL),
        "sddmm")
    out["edge_softmax"] = hold_both(on_both(
        lambda to, s_: edge_softmax(graphs[to], 3 * s_),
        arrays((e, h), (e, h)), dev), (BWD_TOL,), "edge_softmax")
    data = torch.from_numpy(arrays((e, 3))[0])
    got = edge_transpose(graphs[dev], data.to(dev)).cpu()
    assert torch.equal(got, edge_transpose(pub_flat, data))
    out["edge_transpose"] = 0.0
    return out


def check_naive(pub, pub_flat, cora, rng, dev):
    """gat_naive against gat_aggregate on the card (pubmed, p 0 and 0.3,
    forward and the gradients of ar, ac, feat), gmm_naive against the flat
    gmm_aggregate (pubmed, forward and the gradients of feat, pseudo, mu,
    inv_sigma), and on cora, whose hub block counts a duplicate edge once,
    the size of the difference between the two GAT functions."""
    from dgnn_tpu_torch.ops import gat_aggregate, gmm_aggregate
    from dgnn_tpu_torch.ops.naive import gat_naive, gmm_naive
    from dgnn_tpu_torch.ops.primitives import edge_rows

    h, f = SHAPES[0]
    lines = []
    n = pub.num_nodes
    for p in (0.0, 0.3):
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((n, h), (n, h), (n, h, f), (n, h, f))]
        arrs[-1] *= G_SCALE
        res = {}
        for name, fn in (("naive", gat_naive), ("fused", gat_aggregate)):
            ins = [torch.from_numpy(a).to(dev).requires_grad_(True)
                   for a in arrs[:3]]
            out = fn(pub, *ins, attn_drop=p, seed=SEED, training=True)
            out.backward(torch.from_numpy(arrs[3]).to(dev))
            res[name] = [out.detach()] + [t.grad for t in ins]
        worst = 0.0
        for i, (a, b) in enumerate(zip(res["naive"], res["fused"])):
            torch.testing.assert_close(a, b, **(FWD_TOL if i == 0
                                                else BWD_TOL))
            worst = max(worst, float((a - b).abs().max()))
        lines.append(f"gat_naive = gat_aggregate pubmed H={h} F={f} p={p}, "
                     f"out and d(ar, ac, feat) (max |diff| {worst:.3g})")
    k, d = 3, 2
    e = pub_flat.num_edges
    arrs = [rng.normal(size=(n, k, f)), rng.normal(size=(e, d)),
            rng.normal(scale=0.5, size=(k, d)), rng.random((k, d)) + 0.5,
            rng.normal(size=(n, k, f)) * G_SCALE]
    arrs = [a.astype(np.float32) for a in arrs]
    res = {}
    for name, fn in (("naive", gmm_naive), ("fused", gmm_aggregate)):
        ins = [torch.from_numpy(a).to(dev).requires_grad_(True)
               for a in arrs[:4]]
        out = fn(pub_flat, *ins)
        out.backward(torch.from_numpy(arrs[4]).to(dev))
        res[name] = [out.detach()] + [t.grad for t in ins]
    # mu and inv_sigma: sums over every edge in another order
    param_tol = dict(rtol=PARAM_TOL["rtol"],
                     atol=PARAM_TOL["atol_per_edge"] * e)
    worst = 0.0
    for i, (a, b) in enumerate(zip(res["naive"], res["fused"])):
        torch.testing.assert_close(
            a, b, **(FWD_TOL if i == 0 else BWD_TOL if i < 3 else param_tol))
        worst = max(worst, float((a - b).abs().max()))
    lines.append(f"gmm_naive = flat gmm_aggregate pubmed K={k} F={f} D={d}, "
                 f"out and d(feat, pseudo, mu, inv_sigma) (max |diff| "
                 f"{worst:.3g})")
    # cora with its hub block: a multigraph whose duplicates the block
    # counts once (ROADMAP C5)
    n = cora.num_nodes
    ins = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
           for s in ((n, h), (n, h), (n, h, f))]
    with torch.no_grad():
        a = gat_naive(cora, *ins)
        b = gat_aggregate(cora, *ins, dense_dtype="float32")
    off = ~torch.isclose(a, b, **FWD_TOL)
    pairs = edge_rows(cora) * n + cora.col_ind.long()
    dup = cora.num_edges - int(torch.unique(pairs).numel())
    lines.append(f"cora (hub block, dense_dtype float32) H={h} F={f}: "
                 f"{cora.num_edges} edges, {dup} duplicates; gat_naive and "
                 f"gat_aggregate differ in {int(off.any(dim=(1, 2)).sum())} of "
                 f"{n} rows, max |diff| {float((a - b).abs().max()):.4g}, "
                 f"{int(off.sum())} of {off.numel()} elements outside "
                 "FWD_TOL")
    return lines


def check_checkpoint(trainer, dev, tmp):
    """train_edgeconv_torch.py at full width on few clouds: a run that saves
    after training; the trainer's restore into a model of another seed
    gives the first run's eval logits exactly; a second run loads the
    step before it trains."""
    from dgnn_tpu_torch.models import DGCNN

    argv = ["--num-epochs", "1", "--train-samples", "320", "--test-samples",
            "64", "--device", "cuda"]
    r = trainer.run(trainer.parser().parse_args(
        argv + ["--save-model-path", tmp]))
    x = r["x_test"]
    fresh = DGCNN(k=EC_K, output_classes=r["n_classes"], dropout=0.5,
                  generator=torch.Generator().manual_seed(9)).to(dev)
    args = trainer.parser().parse_args(argv + ["--load-model-path", tmp])
    step = trainer.restore_checkpoint(trainer.checkpoint_manager(args),
                                      fresh)
    assert step == 1, step
    with torch.no_grad():
        want = r["model"].eval()(x)
        got = fresh.eval()(x)
    assert torch.equal(got, want), float((got - want).abs().max())
    r2 = trainer.run(args)
    assert r2["restored_step"] == 1 and all(np.isfinite(r2["losses"]))
    return (f"train_edgeconv_torch.py B={EC_B} P={EC_P} k={EC_K}, "
            f"{r['train_steps']} steps, saved to a checkpoint; restored "
            f"into a model of another seed: eval logits on {x.shape[0]} "
            f"clouds equal ({tuple(got.shape)}); a second run restored step "
            f"{r2['restored_step']} and trained {r2['train_steps']} steps, "
            f"loss {r2['losses'][0]:.4f} -> {r2['losses'][-1]:.4f}")


# ---------------------------------------------------------------------------
# phase "sharded": the sharded path (dgnn_tpu_torch/parallel), SHARD_P ranks
# sharing the one card
# ---------------------------------------------------------------------------


def dedup_edges(src, dst, n):
    """The edge list without repeated (src, dst) pairs.  Every comparison
    of the sharded path with the single-device one builds both from it: a
    hub block counts a repeated edge once and the bins every copy (ROADMAP
    C5), and the shards' block plans differ from the single-device plan."""
    key = np.unique(np.asarray(src, np.int64) * n + np.asarray(dst))
    return key // n, key % n


def shard_tables(gat_forward, view, h, f, rng):
    """``tables`` on one shard: destinations are its C rows, sources its C +
    P*Hmax extended rows; M, 1 / L and ws from the shard's forward (plain
    versions, float32).  CPU tensors."""
    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))

    c, ext = view.nodes_per_shard, view.ext_size
    tb = dict(feat=t(ext, h, f), ac=t(ext, h), ar=t(c, h),
              g=t(c, h, f, scale=G_SCALE))
    out, M, L, _, _ = gat_forward(view.fwd, tb["ar"], tb["ac"], tb["feat"],
                                  SLOPE, 0.0, 0, "float32", with_pos=False)
    tb["M"] = M
    tb["Linv"] = 1.0 / torch.clamp(L, min=1e-20)
    tb["ws"] = (tb["g"] * out).sum(dim=-1)
    return tb


def gid_jobs(bins, dense, view, tb):
    """The four gid kernels' calls over one shard as the sharded op makes
    them (p 0.3, every bin of a direction in one call, the hub block in
    float32): {name: (kernel call, the same call without gid, plain call,
    inputs for ``bound``, edges)}; each call returns a list of results."""
    gid = view.ext_gids
    fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=SEED)
    bkw = dict(slope=SLOPE, p=0.3, seed=SEED)
    ks = dict(seed=card_seed(tb["ac"]))  # the kernels': from the card
    la = (tb["feat"], tb["ac"], tb["ar"], view.fwd.segs())
    lb = (*(tb[k] for k in GAT_BWD_KEYS), view.bwd.segs())
    jobs = {
        "bin_gat_fwd_gid": (
            lambda: [bins.bin_gat_fwd_list(*la, **fkw | ks, gid=gid)],
            lambda: [bins.bin_gat_fwd_list(*la, **fkw | ks)],
            lambda: [bins.bin_gat_fwd_list_plain(*la, **fkw, gid=gid)],
            [*la[:3], *flat(la[3]), gid], edges_of(view.fwd)),
        "bin_gat_bwd_gid": (
            lambda: [bins.bin_gat_bwd_list(*lb, **bkw | ks, gid=gid)],
            lambda: [bins.bin_gat_bwd_list(*lb, **bkw | ks)],
            lambda: [bins.bin_gat_bwd_list_plain(*lb, **bkw, gid=gid)],
            [*lb[:7], *flat(lb[7]), gid], edges_of(view.bwd))}
    if view.fwd.dense is not None:
        fa = (view.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
        ba = (view.bwd.dense, *(tb[k] for k in GAT_BWD_KEYS))
        dfkw, dbkw = (dict(kw, dense_dtype="float32") for kw in (fkw, bkw))
        jobs["dense_gat_fwd_gid"] = (
            lambda: [dense.dense_gat_fwd(*fa, **dfkw | ks, gid=gid)],
            lambda: [dense.dense_gat_fwd(*fa, **dfkw | ks)],
            lambda: [dense.dense_gat_fwd_plain(*fa, **dfkw, gid=gid)],
            block_inputs(fa[0], [tb["ar"]], [tb["ac"], tb["feat"]], [gid]),
            block_edges(fa[0]))
        jobs["dense_gat_bwd_gid"] = (
            lambda: [dense.dense_gat_bwd(*ba, **dbkw | ks, gid=gid)],
            lambda: [dense.dense_gat_bwd(*ba, **dbkw | ks)],
            lambda: [dense.dense_gat_bwd_plain(*ba, **dbkw, gid=gid)],
            block_inputs(ba[0], [tb["ac"], tb["feat"]],
                         [tb[k] for k in GAT_BWD_KEYS[:5]], [gid]),
            block_edges(ba[0]))
    return jobs


def check_gid_kernels(bins, dense, view, tb, err):
    """The gid kernels against their plain versions on one shard, p 0.3:
    the bin kernels' list calls with and without the sign-split partials
    (sum_tol), the hub-block kernels in both dense dtypes (BLOCK_TOL with
    its atol grown with the shard's widest block row, ``hub_tol``, as
    check_dense on the skewed block: the plain version sums a row of
    thousands of terms with ``index_add_`` on the card, whose order changes
    from run to run; bf16 flips as check_dense).  Returns the number of
    comparisons and the hub blocks' atol (None without a block)."""
    gid = view.ext_gids
    ks = dict(seed=card_seed(tb["ac"], torch.int32))  # the kernels' seed
    n_cmp = 0
    la = (tb["feat"], tb["ac"], tb["ar"], view.fwd.segs())
    for with_pos in (True, False):
        kw = dict(slope=SLOPE, with_pos=with_pos, p=0.3, seed=SEED, gid=gid)
        for g, w in zip(bins.bin_gat_fwd_list(*la, **kw | ks),
                        bins.bin_gat_fwd_list_plain(*la, **kw)):
            if w is None:
                assert g is None
                continue
            torch.testing.assert_close(g, w, **sum_tol(view.fwd, FWD_TOL))
            err["bin_gat_fwd_gid"] = max(err["bin_gat_fwd_gid"],
                                         float((g - w).abs().max()))
        n_cmp += 1
    lb = (*(tb[k] for k in GAT_BWD_KEYS), view.bwd.segs())
    kw = dict(slope=SLOPE, p=0.3, seed=SEED, gid=gid)
    for g, w in zip(bins.bin_gat_bwd_list(*lb, **kw | ks),
                    bins.bin_gat_bwd_list_plain(*lb, **kw)):
        torch.testing.assert_close(g, w, **sum_tol(view.bwd, BWD_TOL))
        err["bin_gat_bwd_gid"] = max(err["bin_gat_bwd_gid"],
                                     float((g - w).abs().max()))
    n_cmp += 1
    if view.fwd.dense is None:
        return n_cmp, None
    tol = hub_tol(view, BLOCK_TOL)
    for dt in DENSE_DTYPES:
        for with_pos in (True, False):
            kw = dict(slope=SLOPE, with_pos=with_pos, p=0.3, seed=SEED,
                      dense_dtype=dt, gid=gid)
            args = (view.fwd.dense, tb["ar"], tb["ac"], tb["feat"])
            for g, w in zip(dense.dense_gat_fwd(*args, **kw | ks),
                            dense.dense_gat_fwd_plain(*args, **kw)):
                if w is None:
                    continue
                e, _ = assert_close(g, w, tol, dt, f"fwd gid {dt}: ")
                err["dense_gat_fwd_gid"] = max(err["dense_gat_fwd_gid"], e)
            n_cmp += 1
        kw = dict(slope=SLOPE, p=0.3, seed=SEED, dense_dtype=dt, gid=gid)
        args = (view.bwd.dense, *(tb[k] for k in GAT_BWD_KEYS))
        for g, w in zip(dense.dense_gat_bwd(*args, **kw | ks),
                        dense.dense_gat_bwd_plain(*args, **kw)):
            e, _ = assert_close(g, w, tol, dt, f"bwd gid {dt}: ")
            err["dense_gat_bwd_gid"] = max(err["dense_gat_bwd_gid"], e)
        n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp, tol["atol"]


def sharded_rank(rank, world, specs, ec_spec, jobs):
    """One rank of the phase's P-rank run: each comparison spec (the
    sharded model on this shard: its rows' output, the summed parameter
    gradients of its share of the loss, and the launches it made, every
    count set to 0 just before), the data-parallel DGCNN step's comparison
    (parallel.trainer.dgcnn_grads, the same way; its loss share and batch
    norm statistics beside), then each training job
    (parallel.trainer.train_rank)."""
    from dgnn_tpu_torch.parallel.trainer import (dgcnn_grads, shard_loss,
                                                 spec_grads, train_rank)

    dev = torch.device("cuda", 0)
    compared = {}
    for name, s in specs.items():
        n_train = float(s["train_mask"].sum())

        def loss(out, rows, s=s, n_train=n_train):
            return shard_loss(out, rows(s["labels"].astype(np.int64)),
                              rows(s["train_mask"]), n_train)

        reset_all_launches()
        out, grads = spec_grads(s, rank, loss, dev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in all_launches().items() if v}
        compared[name] = (out.cpu().numpy(),
                          {k: g.cpu() for k, g in grads.items()}, launches)
    reset_all_launches()
    r = dgcnn_grads(ec_spec, rank, world, dev)
    torch.cuda.synchronize()
    compared[EC_DP] = (r["logits"].cpu().numpy(),
                       {k: g.cpu() for k, g in r["grads"].items()},
                       {k: v for k, v in all_launches().items() if v})
    ec = (float(r["loss"]), {k: v.cpu() for k, v in r["stats"].items()})
    trained = [train_rank(rank, world, job) for job in jobs]
    return compared, ec, trained, collective_ms(jobs[0], jobs[-1], rank,
                                                dev)


def train_jobs(rank, world, jobs):
    """One rank of a P-rank run of training jobs (parallel.trainer)."""
    from dgnn_tpu_torch.parallel.trainer import train_rank

    return [train_rank(rank, world, job) for job in jobs]


def collective_ms(job, ec_job, rank, dev):
    """ms a call of the training steps' collectives alone, on this rank,
    after the runs: one halo exchange of the GAT ``job``'s hidden-layer
    payload (features ++ attn_col, [C, H*F + H] float32) and one
    all-reduce of its model's gradients (every parameter, float32); one
    all-reduce of the DGCNN ``ec_job``'s gradients and one of its first
    batch norm's sums ([2, C] float32)."""
    import torch.distributed as dist

    from dgnn_tpu_torch.models import DGCNN
    from dgnn_tpu_torch.parallel import ShardedGAT, halo_exchange, shard_view
    from dgnn_tpu_torch.utils import time_calls

    view = shard_view(job.shards, rank, dev)
    width = job.heads[0] * job.n_hidden
    payload = torch.randn(view.nodes_per_shard, width + job.heads[0],
                          device=dev)
    n_params = sum(p.numel() for p in ShardedGAT(
        job.features.shape[1], len(job.heads) - 1, job.n_hidden,
        job.n_classes, job.heads).parameters())
    grads = torch.randn(n_params, device=dev)
    ec_params = sum(p.numel() for p in DGCNN(
        k=ec_job.k, feature_dims=ec_job.feature_dims,
        emb_dims=ec_job.emb_dims, output_classes=ec_job.n_classes
    ).parameters())
    ec_grads = torch.randn(ec_params, device=dev)
    bn_sums = torch.randn(2, ec_job.emb_dims[1], device=dev)

    def ms(fn):
        return time_calls(fn, dev, iters=10, warmup=2) * 1e3

    return dict(
        exchange_ms=ms(lambda: halo_exchange(payload, view.send_ids)),
        allreduce_ms=ms(lambda: dist.all_reduce(grads)), params=n_params,
        ec_allreduce_ms=ms(lambda: dist.all_reduce(ec_grads)),
        bn_allreduce_ms=ms(lambda: dist.all_reduce(bn_sums)))


def compare_spec(kind, shards, graph, data, state_model, dev, *, seeds=None,
                 pseudo=None, pseudo_args=()):
    """One comparison: the single-device port model ``state_model`` on the
    card (forward and every parameter gradient of the masked cross entropy
    over the training rows), and the spec the ranks run with its weights."""
    feats = torch.from_numpy(data["features"]).to(dev)
    labels = torch.from_numpy(data["labels"].astype(np.int64)).to(dev)
    mask = torch.from_numpy(data["train_mask"]).to(dev)
    from dgnn_tpu_torch.parallel.trainer import shard_loss

    model = state_model.to(dev).train(seeds is not None)
    kw = {} if seeds is None else dict(attn_seeds=seeds)
    out = model(graph, feats, *pseudo_args, **kw)
    shard_loss(out, labels, mask, float(data["train_mask"].sum())).backward()
    want = (out.detach().cpu().numpy(),
            {k: p.grad.cpu() for k, p in model.named_parameters()})
    spec = dict(model=kind, shards=shards, training=seeds is not None,
                seeds=seeds,
                state={k: v.cpu() for k, v in model.state_dict().items()},
                features=data["features"], labels=data["labels"],
                train_mask=data["train_mask"], pseudo=pseudo, **data["extra"])
    return spec, want


def check_compared(name, want, got_ranks, n, grad_tol=None):
    """The ranks' rows of the output (concatenated, the real n) and every
    rank's summed gradients against the single-device run on the card;
    ``grad_tol(name, want)``: a gradient's tolerance, SHARD_GRAD_TOL's
    by default."""
    out = np.concatenate([r[name][0] for r in got_ranks])[:n]
    scale = float(np.abs(want[0]).max())
    torch.testing.assert_close(
        torch.from_numpy(out), torch.from_numpy(want[0]),
        rtol=SHARD_FWD_TOL["rtol"], atol=SHARD_FWD_TOL["atol_scale"] * scale,
        msg=lambda m: f"{name} output (largest |element| {scale:.4g}): {m}")
    worst = float(np.abs(out - want[0]).max())
    g0 = got_ranks[0][name][1]
    assert set(g0) == set(want[1]), (name, sorted(g0), sorted(want[1]))
    for k, w in want[1].items():
        tol = (grad_tol or shard_grad_tol)(k, w)
        torch.testing.assert_close(g0[k], w, **tol,
                                   msg=lambda m: f"{name} d {k}: {m}")
        for r in got_ranks[1:]:
            assert torch.equal(r[name][1][k], g0[k]), (name, k)
    return worst


def shard_grad_tol(name, w):
    """SHARD_GRAD_TOL for the gradient ``w``: atol a share of its largest
    element."""
    return dict(rtol=SHARD_GRAD_TOL["rtol"],
                atol=SHARD_GRAD_TOL["atol_scale"] * float(w.abs().max()))


def bn_fed_bias(name):
    """Whether DGCNN's parameter ``name`` is a bias that feeds a batch norm
    (proj's, through the pooling, and the embeddings'): its gradient is 0
    exactly, the norm removing any shift."""
    return name == "proj.bias" or (name.startswith("embs.")
                                   and name.endswith(".bias"))


def grad_shares(want, got):
    """The largest |got - want| over the largest |want| element, of the
    EdgeConv layers' gradients (one per tensor, rounded) and of the rest's
    (the largest), biases before a batch norm left out."""
    share = {k: float((got[k] - w).abs().max() / w.abs().max())
             for k, w in want.items()}
    conv = {k.removeprefix("convs."): float(f"{v:.3g}")
            for k, v in share.items() if k.startswith("convs.")}
    rest = max(v for k, v in share.items()
               if not k.startswith("convs.") and not bn_fed_bias(k))
    return conv, rest


def dgcnn_grad_tol(grads):
    """``check_compared``'s tolerances for the data-parallel DGCNN step's
    gradients ``grads`` (the single-device step's): SHARD_GRAD_TOL, but
    EC_DP_CONV_TOL for the EdgeConv layers' and, for a bias that feeds a
    batch norm, an atol of SHARD_GRAD_TOL's share of the model's largest
    gradient element (see EC_DP_CONV_TOL)."""
    largest = max(float(w.abs().max()) for w in grads.values())

    def tol(name, w):
        if name.startswith("convs."):
            return dict(rtol=EC_DP_CONV_TOL["rtol"],
                        atol=EC_DP_CONV_TOL["atol_scale"]
                        * float(w.abs().max()))
        if bn_fed_bias(name):
            return dict(rtol=0.0, atol=SHARD_GRAD_TOL["atol_scale"] * largest)
        return shard_grad_tol(name, w)

    return tol


def check_dgcnn_step(want, ranks):
    """The data-parallel DGCNN step's loss (the ranks' shares summed) at
    SHARD_GRAD_TOL and every rank's batch-norm running statistics at
    SHARD_FWD_TOL against the single-device step's, the statistics equal
    on every rank.  Returns the loss's and the statistics' max |diff|."""
    want_loss, want_stats = want
    loss = sum(r[0] for r in ranks)
    assert abs(loss - want_loss) <= SHARD_GRAD_TOL["rtol"] * abs(want_loss), \
        (loss, want_loss)
    worst = 0.0
    for k, w in want_stats.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(
            ranks[0][1][k], w, rtol=SHARD_FWD_TOL["rtol"],
            atol=SHARD_FWD_TOL["atol_scale"] * scale,
            msg=lambda m: f"{EC_DP} {k}: {m}")
        worst = max(worst, float((ranks[0][1][k] - w).abs().max()))
        for r in ranks[1:]:
            assert torch.equal(r[1][k], ranks[0][1][k]), k
    return abs(loss - want_loss), worst


def check_dgcnn_training(runs, n_params, emb_dims):
    """One P-rank run of parallel.trainer.train_dgcnn_rank: the loss (the
    ranks' shares summed) finite and falling, the ranks' final digests
    equal, each rank's launches and all-reduces exactly what the steps
    imply (one of the gradients and, forward and backward, one a batch
    norm, a step; a batch norm follows each embedding past the first,
    ``emb_dims``).
    Returns its line: the slowest rank's ms a step, the
    loss, all-reduces and bytes a step a rank, route, peak MB."""
    steps = SHARD_STEPS + SHARD_WARMUP
    loss = [sum(v) for v in zip(*(r["losses"] for r in runs))]
    assert len(loss) == steps and all(np.isfinite(loss)), loss
    assert loss[-1] < loss[0], loss
    assert len({r["digest"] for r in runs}) == 1, [r["digest"] for r in runs]
    # the batch norms' sums and sums of squares, forward and backward
    n_bns, bn_bytes = len(emb_dims) - 1, 2 * 2 * 4 * sum(emb_dims[1:])
    for r in runs:
        assert r["launches"] == {k: v * steps
                                 for k, v in EC_DP_LAUNCHES.items()}, \
            r["launches"]
        assert r["allreduces"]["allreduces"] == (1 + 2 * n_bns) * steps, \
            r["allreduces"]
        assert r["allreduces"]["bytes"] == steps * (4 * n_params + bn_bytes)
    ar = runs[0]["allreduces"]
    return dict(ms=max(r["step_s"] for r in runs) * 1e3, loss=loss,
                allreduces=ar["allreduces"] // steps,
                bytes=ar["bytes"] // steps, route=ar["route"],
                peak_mb=max(r["peak_mb"] for r in runs))


def train_line(results, shards):
    """ms a step (the slowest rank), halo plan, exchange bytes and route,
    peak MB a rank, the loss (the ranks' shares summed) of one run."""
    ex = results[0]["exchanges"]
    loss = [sum(v) for v in zip(*(r["losses"] for r in results))]
    return dict(
        ms=max(r["step_s"] for r in results) * 1e3, loss=loss,
        halo_rows=int(shards.halo_counts.sum()), halo_max=shards.halo_max,
        bytes_per_exchange=ex["bytes"] // max(ex["exchanges"], 1),
        exchanges=ex["exchanges"], route=ex["route"],
        peak_mb=max(r["peak_mb"] for r in results))


def expected_shard_launches(bins, shards, kind, calls, gid):
    """Launches each rank makes in ``calls`` layer passes (forward and
    backward) of a ``kind`` model ("gat" or "gmm", PATH_KERNELS) over its
    shard: one list call per direction, and one hub-block call where the
    shard has a block; the GAT's under their gid names when attention
    dropout is on (``gid``)."""
    from dgnn_tpu_torch.parallel import shard_view

    names = [k + "_gid" if gid else k for k in PATH_KERNELS[kind]]
    out = []
    for v in (shard_view(shards, p) for p in range(shards.num_shards)):
        want = {names[0]: calls * list_launches(bins, v.fwd),
                names[1]: calls * list_launches(bins, v.bwd),
                names[2]: calls * (v.fwd.dense is not None),
                names[3]: calls * (v.bwd.dense is not None)}
        out.append({k: n for k, n in want.items() if n})
    return out


def reddit_cut(scale, n_feats_classes):
    """The reddit R-MAT graph at ``scale`` of its size, deduplicated, and
    its task (data/reddit.py's: structure_task_from_csr)."""
    from dgnn_tpu_torch.data.reddit import reddit_size
    from dgnn_tpu_torch.data.synthetic import (rmat_edges,
                                               structure_task_from_csr)
    from dgnn_tpu_torch.graph import build as gbuild

    n, e = reddit_size(scale)
    src, dst = dedup_edges(*rmat_edges(n, e, seed=0), n)
    s2, d2 = gbuild.add_self_loops(*gbuild.remove_self_loops(src, dst), n)
    row_ptr, col_ind = gbuild.coo_to_csr(s2, d2, n)
    n_feats, n_classes = n_feats_classes
    feats, labels, tr, _va, _te = structure_task_from_csr(
        row_ptr, col_ind, n_classes, n_feats, seed=0)
    return dict(src=src, dst=dst, n=n, features=feats, labels=labels,
                train_mask=tr, n_classes=n_classes)


def run_sharded(bins, dense, structure, gat_forward, dev, smi, err,
                time_calls, graph_ms):
    """The sharded phase.  Returns (launches of the P-rank training runs,
    summed over ranks and runs; the gid kernels' times)."""
    from dgnn_tpu_torch.data import synthetic_citation
    from dgnn_tpu_torch.data.synthetic import CITATION_SHAPES
    from dgnn_tpu_torch.models import GAT, MoNet
    from dgnn_tpu_torch.ops.gmm import NodePseudo, bin_pseudo
    from dgnn_tpu_torch.data import load_modelnet
    from dgnn_tpu_torch.models import DGCNN
    from dgnn_tpu_torch.parallel import (partition_graph, run_ranks,
                                         shard_view)
    from dgnn_tpu_torch.parallel.trainer import (DGCNNJob, GATJob, MoNetJob,
                                                 degree_pseudo)
    from dgnn_tpu_torch.utils.training import smoothed_loss

    t_phase = time.perf_counter()
    srng = np.random.default_rng(11)  # the phase's own draws
    data, shards = {}, {}
    for name, forced in (("pubmed", "auto"), ("cora", CORA_SHARD_FORCED)):
        d = synthetic_citation(name)
        src, dst = dedup_edges(d.src, d.dst, d.num_nodes)
        data[name] = dict(src=src, dst=dst, n=d.num_nodes,
                          features=d.features, labels=d.labels,
                          train_mask=d.train_mask, n_classes=d.n_classes)
        t0 = time.perf_counter()
        shards[name] = partition_graph(src, dst, d.num_nodes, SHARD_P,
                                       dense=forced)
        sh = shards[name]
        phase("sharded", f"{name} ({d.num_nodes} nodes, {len(src)} edges "
              f"after dedup) in {SHARD_P} shards, dense={forced}: C="
              f"{sh.nodes_per_shard}, halo max {sh.halo_max} rows, "
              f"{int(sh.halo_counts.sum())} halo rows in all, hub blocks "
              f"fwd {sh.fwd_dense is not None} bwd {sh.bwd_dense is not None}"
              f", partitioned in {time.perf_counter() - t0:.2f} s")
    assert shards["cora"].fwd_dense is not None
    assert shards["cora"].bwd_dense is not None

    t0 = time.perf_counter()
    red = reddit_cut(SHARD_REDDIT_SCALE, CITATION_SHAPES["reddit"][2:])
    red_sh = partition_graph(red["src"], red["dst"], red["n"], SHARD_P,
                             dense="auto")
    phase("sharded", f"reddit at scale {SHARD_REDDIT_SCALE} ({red['n']} "
          f"nodes, {len(red['src'])} edges after dedup): R-MAT, task and "
          f"{SHARD_P} shards (dense=auto: hub blocks fwd "
          f"{red_sh.fwd_dense is not None} bwd {red_sh.bwd_dense is not None}"
          f", C={red_sh.nodes_per_shard}, halo max {red_sh.halo_max}) in "
          f"{time.perf_counter() - t0:.1f} s on the host")

    # the gid kernels against their plain versions on shard 1's layout, at
    # the widths the training runs give them (pubmed, reddit) and on cora's
    # forced blocks; their times with and without the table on pubmed's
    # bins and cora's blocks at the hidden width
    shard_times = {}
    for name, sh, shapes, timed in (
            ("pubmed", shards["pubmed"], SHAPES, "bin"),
            ("cora", shards["cora"], DENSE_SHAPES, "dense"),
            (f"reddit scale {SHARD_REDDIT_SCALE}", red_sh, REDDIT_SHAPES,
             None)):
        view = shard_view(sh, 1)
        for h, f in shapes:
            tb = {k: v.to(dev) for k, v in
                  shard_tables(gat_forward, view, h, f, srng).items()}
            vd = view.to(dev)
            n_cmp, block_atol = check_gid_kernels(bins, dense, vd, tb, err)
            phase("sharded", f"{name} shard 1 H={h} F={f} p=0.3: {n_cmp} "
                  "gid kernel/plain comparisons agree" + (
                      "" if block_atol is None else
                      f" (hub blocks' atol {block_atol:.3g}, grown with the "
                      "widest block row)"))
            if timed is None or (h, f) != shapes[0]:
                continue
            for kname, (fn, fn_nogid, fn_plain, inputs, edges) in gid_jobs(
                    bins, dense, vd, tb).items():
                if not kname.startswith(timed):
                    continue
                _, plain_ms = time_pair(fn, fn_plain, time_calls, dev)
                ms = graph_ms(fn, dev, 10)
                nogid_ms = graph_ms(fn_nogid, dev, 10)
                bound_ms, bound_by = bound(kname, inputs, flat(fn()), edges,
                                           h * f, h)
                shard_times[(kname, h, f)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, no_gid_ms=nogid_ms)
                phase("sharded", f"{kname} {name} shard 1 H={h} F={f} p=0.3 "
                      f"({edges} edges): {ms:.4f} ms with gid, "
                      f"{nogid_ms:.4f} ms without, plain {plain_ms:.4f} ms, "
                      f"bound {bound_ms:.4f} ms ({bound_by}) | {smi}")
            del tb, vd

    # the sharded models against the single-device port on the card, same
    # weights, dense_dtype float32, forward and every parameter gradient
    gen = torch.Generator().manual_seed(5)
    specs, wants = {}, {}
    for name, dsname in (("gat pubmed", "pubmed"),
                         ("gat cora forced block", "cora")):
        dd = data[dsname]
        graph = structure.build_graph(
            dd["src"], dd["dst"], dd["n"], edge_tables=False,
            dense="auto" if dsname == "pubmed" else None).to(dev)
        kw = dict(in_feats=dd["features"].shape[1], num_layers=1,
                  n_hidden=64, n_classes=dd["n_classes"], heads=(4, 1),
                  feat_drop=0.0, attn_drop=0.3)
        model = GAT(kw["in_feats"], 1, 64, dd["n_classes"], (4, 1),
                    attn_drop=0.3, generator=gen)
        seeds = [int(s) for s in srng.integers(0, 2 ** 32, 2)]
        specs[name], wants[name] = compare_spec(
            "gat", shards[dsname], graph, dict(dd, extra={}), model, dev,
            seeds=seeds)
        specs[name]["kwargs"] = dict(kw, dense_dtype="float32")
    # MoNet: node pseudo on cora (forced block), binned pseudo on pubmed
    dd = data["cora"]
    graph = structure.build_graph(dd["src"], dd["dst"], dd["n"],
                                  edge_tables=False).to(dev)
    deg = np.bincount(np.concatenate([dd["dst"], np.arange(dd["n"])]),
                      minlength=dd["n"])
    rsq = (1.0 / np.sqrt(np.maximum(deg, 1))).astype(np.float32)[:, None]
    kw = dict(in_feats=dd["features"].shape[1], n_hidden=64,
              out_feats=dd["n_classes"], n_layers=1, dim=GMM_D, n_kernels=3,
              dropout=0.0, pseudo="node")
    model = MoNet(**kw, generator=gen)
    npseudo = NodePseudo(src=torch.from_numpy(rsq).to(dev),
                         dst=torch.from_numpy(rsq).to(dev))
    specs["monet node cora forced block"], wants[
        "monet node cora forced block"] = compare_spec(
        "monet", shards["cora"], graph, dict(dd, extra=dict(
            psrc=rsq, pdst=rsq)), model, dev, pseudo="node",
        pseudo_args=(npseudo,))
    specs["monet node cora forced block"]["kwargs"] = dict(
        kw, dense_dtype="float32")
    dd = data["pubmed"]
    graph = structure.build_graph(dd["src"], dd["dst"], dd["n"],
                                  edge_tables=True).to(dev)
    pflat = srng.normal(size=(graph.num_edges, 2)).astype(np.float32)
    kw = dict(in_feats=dd["features"].shape[1], n_hidden=64,
              out_feats=dd["n_classes"], n_layers=1, dim=GMM_D, n_kernels=3,
              dropout=0.0, pseudo="binned")
    model = MoNet(**kw, generator=gen)
    specs["monet binned pubmed"], wants["monet binned pubmed"] = compare_spec(
        "monet", shards["pubmed"], graph, dict(dd, extra=dict(
            pseudo_flat=pflat)), model, dev, pseudo="binned",
        pseudo_args=(bin_pseudo(graph, torch.from_numpy(pflat).to(dev)),))
    specs["monet binned pubmed"]["kwargs"] = dict(kw, dense_dtype="float32")
    del graph, model
    # DGCNN batch data parallel at the trainer's width (B = EC_B, P = EC_P,
    # k = EC_K, dropout 0.5): one training step of the single-device port
    # model on the whole batch on the card, its weights, clouds and
    # generator seed handed to the ranks (data-parallel, EC_B / SHARD_P
    # clouds a rank)
    xtr, ytr, _xte, yte = load_modelnet(num_points=EC_P)
    ec_kw = dict(k=EC_K, output_classes=int(max(ytr.max(), yte.max())) + 1,
                 dropout=0.5)
    model = DGCNN(**ec_kw, generator=torch.Generator().manual_seed(0))
    ec_spec = dict(kwargs=ec_kw, state=copy.deepcopy(model.state_dict()),
                   x=xtr[:EC_B], y=ytr[:EC_B], seed=3)
    model = model.to(dev).train()
    logits = model(torch.from_numpy(ec_spec["x"]).to(dev),
                   generator=torch.Generator(device=dev).manual_seed(3))
    ec_loss = smoothed_loss(logits, torch.from_numpy(
        ec_spec["y"].astype(np.int64)).to(dev))
    ec_loss.backward()
    wants[EC_DP] = (logits.detach().cpu().numpy(),
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
    ec_want = (float(ec_loss), {k: v.cpu()
                                for k, v in model.bns.named_buffers()})
    n_params = sum(p.numel() for p in model.parameters())
    del model, logits, ec_loss
    torch.cuda.empty_cache()

    # training: GAT at the bench width (feat_drop 0.5, attn_drop 0.3);
    # MoNet at its CLI's (hidden 64, K 3, dim 2, dropout 0.5, Adam 1e-2)
    # with the graft entry's node pseudo; DGCNN at the trainer's
    def job(dd, sh, steps=SHARD_STEPS):
        return GATJob(shards=sh, features=dd["features"], labels=dd["labels"],
                      train_mask=dd["train_mask"], n_classes=dd["n_classes"],
                      steps=steps, warmup=SHARD_WARMUP, device="cuda")

    def monet_job(dd, sh):
        return MoNetJob(shards=sh, features=dd["features"],
                        labels=dd["labels"], train_mask=dd["train_mask"],
                        pseudo=degree_pseudo(dd["dst"], dd["n"]),
                        n_classes=dd["n_classes"], steps=SHARD_STEPS,
                        warmup=SHARD_WARMUP, device="cuda")

    ec_job = DGCNNJob(x_train=xtr, y_train=ytr,
                      n_classes=ec_kw["output_classes"], batch_size=EC_B,
                      k=EC_K, steps=SHARD_STEPS, warmup=SHARD_WARMUP,
                      device="cuda")
    jobs = [job(data["pubmed"], shards["pubmed"]), job(red, red_sh),
            monet_job(data["pubmed"], shards["pubmed"]),
            monet_job(data["cora"], shards["cora"]), ec_job]
    t0 = time.perf_counter()
    compared, ec_ranks, trained, coll = zip(*run_ranks(
        sharded_rank, SHARD_P, specs, ec_spec, jobs))
    phase("sharded", f"{SHARD_P} ranks on the card (gloo): the comparisons "
          f"and the {len(jobs)} training runs took "
          f"{time.perf_counter() - t0:.1f} s (spawn included)")
    # the launches each rank made in its comparison runs, exactly: one
    # forward and one backward over both layers (the GATs with attention
    # dropout on, so under the gid names; binned-pseudo MoNet launches
    # none); DGCNN's, one step's
    want_launches = {
        name: ([{}] * SHARD_P if spec.get("pseudo") == "binned" else
               expected_shard_launches(
                   bins, spec["shards"], "gat" if spec["model"] == "gat"
                   else "gmm", 2, gid=spec["model"] == "gat"))
        for name, spec in specs.items()}
    want_launches[EC_DP] = [EC_DP_LAUNCHES] * SHARD_P
    for name in want_launches:
        worst = check_compared(
            name, wants[name], compared, wants[name][0].shape[0],
            dgcnn_grad_tol(wants[name][1]) if name == EC_DP else None)
        got = [r[name][2] for r in compared]
        assert got == want_launches[name], (name, got, want_launches[name])
        phase("sharded", f"{name}: {SHARD_P}-rank sharded model = the "
              "single-device model on the card, same weights{}: output (max "
              "|diff| {:.3g}; rtol {}, atol {} of the largest) and every "
              "parameter gradient (rtol {}, atol {} of the largest{}) on "
              "every rank; launches a rank {} (exact)".format(
                  "" if name == EC_DP else ", dense_dtype float32", worst,
                  SHARD_FWD_TOL["rtol"], SHARD_FWD_TOL["atol_scale"],
                  SHARD_GRAD_TOL["rtol"], SHARD_GRAD_TOL["atol_scale"],
                  "" if name != EC_DP else
                  "; the EdgeConv layers' rtol {}, atol {} of the largest, "
                  "largest |diff| / largest |element| {}; the rest {:.3g}; "
                  "the biases before a batch norm, whose gradient is 0, "
                  "within {} of the model's largest".format(
                      EC_DP_CONV_TOL["rtol"], EC_DP_CONV_TOL["atol_scale"],
                      *grad_shares(wants[name][1], compared[0][name][1]),
                      SHARD_GRAD_TOL["atol_scale"]), got))
    loss_err, stats_err = check_dgcnn_step(ec_want, ec_ranks)
    phase("sharded", f"{EC_DP} B={EC_B} P={EC_P} k={EC_K} dropout 0.5 (the "
          f"global batch's mask; {EC_B // SHARD_P} clouds a rank): the ranks' "
          f"loss shares sum to the single-device loss {ec_want[0]:.6f} "
          f"(|diff| {loss_err:.3g}; rtol {SHARD_GRAD_TOL['rtol']}), the "
          "batch norms' running statistics (global mean and variance) "
          f"within rtol {SHARD_FWD_TOL['rtol']}, atol "
          f"{SHARD_FWD_TOL['atol_scale']} of the largest (max |diff| "
          f"{stats_err:.3g}), equal on every rank")
    launches = {}
    for (title, sh, dd), runs in zip(
            (("pubmed", shards["pubmed"], data["pubmed"]),
             (f"reddit scale {SHARD_REDDIT_SCALE}", red_sh, red)),
            list(zip(*trained))[:2]):
        line = train_line(runs, sh)
        assert all(np.isfinite(line["loss"])), line["loss"]
        assert line["loss"][-1] < line["loss"][0], line["loss"]
        want = expected_shard_launches(
            bins, sh, "gat", (SHARD_STEPS + SHARD_WARMUP) * 2, gid=True)
        for r, w in zip(runs, want):
            assert r["launches"] == w, (title, r["launches"], w)
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        assert all(np.isfinite(r["logits"]).all() for r in runs)
        phase("sharded", f"train {title} GAT heads (4,1) hidden 64 feat_drop "
              f"0.5 attn_drop 0.3, P={SHARD_P}: "
              f"{SHARD_STEPS + SHARD_WARMUP} steps, loss {line['loss'][0]:.4f}"
              f" -> {line['loss'][-1]:.4f}, {line['ms']:.3f} ms/step, halo "
              f"{line['halo_rows']} rows in all (max {line['halo_max']} a "
              f"pair), {line['bytes_per_exchange']} bytes an exchange a rank "
              f"({line['exchanges']} exchanges, route {line['route']}), peak "
              f"{line['peak_mb']:.0f} MB a rank, launches a rank "
              f"{[r['launches'] for r in runs]} (exact; no other kernel "
              f"and no plain version on the card) | {smi}")
    monet_runs = list(zip(*trained))[2:4]
    for (title, sh), runs in zip((("pubmed", shards["pubmed"]),
                                  ("cora forced block", shards["cora"])),
                                 monet_runs):
        line = train_line(runs, sh)
        assert all(np.isfinite(line["loss"])), line["loss"]
        assert line["loss"][-1] < line["loss"][0], line["loss"]
        want = expected_shard_launches(
            bins, sh, "gmm", (SHARD_STEPS + SHARD_WARMUP) * 2, gid=False)
        for r, w in zip(runs, want):
            assert r["launches"] == w, (title, r["launches"], w)
        assert all(np.isfinite(r["logits"]).all() for r in runs)
        phase("sharded", f"train {title} MoNet hidden 64 K 3 dim 2 dropout "
              f"0.5 Adam 1e-2, node pseudo deg^-1/2, P={SHARD_P}: "
              f"{SHARD_STEPS + SHARD_WARMUP} steps, loss "
              f"{line['loss'][0]:.4f} -> {line['loss'][-1]:.4f}, "
              f"{line['ms']:.3f} ms/step, {line['bytes_per_exchange']} bytes "
              f"an exchange a rank ({line['exchanges']} exchanges), peak "
              f"{line['peak_mb']:.0f} MB a rank, launches a rank "
              f"{[r['launches'] for r in runs]} (exact) | {smi}")
    phase("sharded", f"pubmed P={SHARD_P}, the collectives alone (CUDA "
          "events around the call, after the training runs): one halo "
          "exchange of the hidden layer's payload "
          f"{max(c['exchange_ms'] for c in coll):.3f} ms a call (slowest "
          "rank), one all-reduce of the "
          f"{coll[0]['params']} gradients "
          f"{max(c['allreduce_ms'] for c in coll):.3f} ms; a training step "
          "makes 4 exchanges (2 layers, forward and backward) and 1 "
          f"all-reduce | {smi}")
    # ms a step at P = 1, 2 and 4 on pubmed: the ranks share the card, so
    # T(P) / T(1) is the work ratio
    scaling = {SHARD_P: train_line([t[0] for t in trained], shards["pubmed"])}
    ec_runs = {SHARD_P: [t[-1] for t in trained]}
    for p in (1, 2):
        sh = partition_graph(data["pubmed"]["src"], data["pubmed"]["dst"],
                             data["pubmed"]["n"], p, dense="auto")
        runs = run_ranks(train_jobs, p, [
            job(data["pubmed"], sh, SHARD_SCALING_STEPS), ec_job])
        scaling[p] = train_line([r[0] for r in runs], sh)
        ec_runs[p] = [r[1] for r in runs]
    t1 = scaling[1]["ms"]
    phase("sharded", "pubmed GAT bench width, ms a step at P = 1, 2, 4 ranks "
          "on one card (work ratio T(P)/T(1)): " + "; ".join(
              f"P={p} {scaling[p]['ms']:.3f} ms ({scaling[p]['ms'] / t1:.3f})"
              f", halo {scaling[p]['halo_rows']} rows, "
              f"{scaling[p]['bytes_per_exchange']} B an exchange a rank, "
              f"peak {scaling[p]['peak_mb']:.0f} MB a rank, route "
              f"{scaling[p]['route']}" for p in sorted(scaling))
          + f" | {smi}")
    ec_lines = {p: check_dgcnn_training(runs, n_params, ec_job.emb_dims)
                for p, runs in sorted(ec_runs.items())}
    ec1 = ec_lines[1]["ms"]
    phase("sharded", f"train DGCNN B={EC_B} P={EC_P} k={EC_K} dropout 0.5 "
          f"SGD 0.1 cosine, batch data parallel on {len(xtr)} synthetic "
          f"clouds ({SHARD_STEPS + SHARD_WARMUP} steps, {SHARD_WARMUP} of "
          "them warmup, the slowest rank's ms a step), every rank's final "
          "parameters and batch-norm statistics equal bit for bit, launches "
          "exact (masked_max_step8, masked_max_live_lists, tie_sum_bwd, "
          "tie_sum_lists 4 a step a rank, nothing else): " + "; ".join(
              f"P={p} {ln['ms']:.3f} ms ({ln['ms'] / ec1:.3f} of P=1), loss "
              f"{ln['loss'][0]:.4f} -> {ln['loss'][-1]:.4f}, "
              f"{ln['allreduces']} all-reduces and {ln['bytes']} bytes a "
              f"step a rank ({n_params} parameters), route {ln['route']}, "
              f"peak {ln['peak_mb']:.0f} MB a rank"
              for p, ln in ec_lines.items())
          + f"; at P={SHARD_P} the collectives alone (CUDA events around "
          "the call, slowest rank): one all-reduce of the gradients "
          f"{max(c['ec_allreduce_ms'] for c in coll):.3f} ms, one of a "
          f"batch norm's sums {max(c['bn_allreduce_ms'] for c in coll):.3f}"
          " ms, 4 of those a step | " + smi)
    phase("sharded", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, shard_times


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only "
              "on the card", file=sys.stderr)
        return 1
    from dgnn_tpu_torch import native
    from dgnn_tpu_torch.data import synthetic_citation
    from dgnn_tpu_torch.data.reddit import reddit_size
    from dgnn_tpu_torch.graph import structure
    from dgnn_tpu_torch.ops import _build, bins, dense, ec_tiles, edgeconv, \
        gather
    from dgnn_tpu_torch.ops.edgeconv import edge_conv_max_dense
    from dgnn_tpu_torch.ops.gat import _gat_forward, gat_aggregate
    from dgnn_tpu_torch.ops.gmm import gmm_aggregate_node
    from dgnn_tpu_torch.utils import time_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    phase("device", f"{torch.cuda.get_device_name(dev)} | nvidia-smi: {smi} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.library_path().parent / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", f"{build_s:.1f} s -> {_build.library_path()} | "
          + " | ".join(regs))
    t0 = time.perf_counter()
    native.load()  # g++: the host graph build's library
    phase("build", f"native graph library (g++ {' '.join(native.CXX_FLAGS)})"
          f" {time.perf_counter() - t0:.1f} s -> {native.library_path()}")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    d = synthetic_citation("pubmed")
    pub = structure.build_graph(d.src, d.dst, d.num_nodes, dense="auto",
                                edge_tables=False).to(dev)
    assert pub.fwd.dense is None and pub.bwd.dense is None
    err = {k: 0.0 for k in KERNELS}
    tabs = {}
    for h, f in SHAPES:
        tabs[(h, f)] = tables(_gat_forward, pub, h, f, rng, dev)
        n_cmp = check_bins(bins, pub.fwd, pub.bwd, tabs[(h, f)], err)
        phase("kernels", f"pubmed H={h} F={f}: fwd widths {pub.fwd.widths} "
              f"bwd widths {pub.bwd.widths}: {n_cmp} kernel/plain "
              "comparisons agree")
    pl = power_law_graph(structure, rng).to(dev)
    pl_tabs = [tables(_gat_forward, pl, h, f, rng, dev) for h, f in SHAPES]
    pl.fwd.count[-1][0] = 0  # an empty segment in the widest bin
    pl.bwd.count[-1][0] = 0  # and in the backward's
    for (h, f), tb in zip(SHAPES, pl_tabs):
        n_cmp = check_bins(bins, pl.fwd, pl.bwd, tb, err)
        phase("kernels", f"power-law H={h} F={f}: fwd widths "
              f"{pl.fwd.widths} (one empty segment): {n_cmp} comparisons "
              "agree")
    # the bf16 instances (gather_dtype bfloat16) on the same tables, their
    # feature rows rounded to bf16: no new draws from rng
    for name, g, tbs in (("pubmed", pub, [tabs[sh] for sh in SHAPES]),
                         ("power-law", pl, pl_tabs)):
        for (h, f), tb in zip(SHAPES, tbs):
            n_cmp = check_bins(bins, g.fwd, g.bwd, tb, err, torch.bfloat16)
            phase("kernels", f"{name} H={h} F={f} bf16 rows: {n_cmp} "
                  "kernel/plain comparisons agree (the float32 "
                  "tolerances)")
    hubs = {}
    for name in ("cora", "citeseer"):
        dd = synthetic_citation(name)
        hubs[name] = structure.build_graph(dd.src, dd.dst, dd.num_nodes,
                                           dense="auto",
                                           edge_tables=False).to(dev)
    hubs["pubmed forced"] = structure.build_graph(
        d.src, d.dst, d.num_nodes, dense=PUBMED_FORCED,
        edge_tables=False).to(dev)
    cora_tabs = {}
    for name, g in hubs.items():
        for h, f in DENSE_SHAPES:
            tb = tables(_gat_forward, g, h, f, rng, dev)
            if name == "cora":
                cora_tabs[(h, f)] = tb
            n_cmp, n_off = check_dense(dense, g, tb, err)
            phase("kernels", f"{name} H={h} F={f}: fwd block "
                  f"{block_stats(g.fwd)}, bwd block {block_stats(g.bwd)}: "
                  f"{n_cmp} kernel/plain comparisons agree ({n_off} bf16 "
                  "elements outside BLOCK_TOL)")
            # the bins beside the block, at this graph's widths
            n_cmp = check_bins(bins, g.fwd, g.bwd, tb, err)
            phase("kernels", f"{name} H={h} F={f}: fwd widths "
                  f"{g.fwd.widths} bwd widths {g.bwd.widths}: {n_cmp} "
                  "kernel/plain comparisons agree")
    # MoNet draws from a generator of its own, so that the GAT checks see
    # the same numbers whether or not the MoNet ones run
    grng = np.random.default_rng(1)
    gmm_tabs, pl_gmm_tabs = {}, {}
    for k, f in GMM_SHAPES:
        gmm_tabs[(k, f)] = gmm_tables(pub.num_nodes, k, f, grng, dev)
        n_cmp = check_gmm_bins(bins, pub.fwd, pub.bwd, gmm_tabs[(k, f)],
                                  err)
        phase("kernels", f"pubmed MoNet K={k} F={f} D={GMM_D}: {n_cmp} "
              "kernel/plain comparisons agree (tanh on and off)")
        pl_gmm_tabs[(k, f)] = gmm_tables(pl.num_nodes, k, f, grng, dev)
        n_cmp = check_gmm_bins(bins, pl.fwd, pl.bwd, pl_gmm_tabs[(k, f)],
                                  err)
        phase("kernels", f"power-law MoNet K={k} F={f}: fwd widths "
              f"{pl.fwd.widths} (one empty segment): {n_cmp} comparisons "
              "agree")
    for name, g, tbs in (("pubmed", pub, gmm_tabs),
                         ("power-law", pl, pl_gmm_tabs)):
        for (k, f), tb in tbs.items():
            n_cmp = check_gmm_bins(bins, g.fwd, g.bwd, tb, err,
                                   torch.bfloat16)
            phase("kernels", f"{name} MoNet K={k} F={f} bf16 rows: {n_cmp} "
                  "kernel/plain comparisons agree (the float32 "
                  "tolerances)")
    cora_gmm_tabs = {}
    for name, g in hubs.items():
        for k, f in GMM_DENSE_SHAPES:
            tb = gmm_tables(g.num_nodes, k, f, grng, dev)
            if name == "cora":
                cora_gmm_tabs[(k, f)] = tb
            n_cmp, n_off = check_gmm_dense(dense, g, tb, err)
            phase("kernels", f"{name} MoNet K={k} F={f} D={GMM_D}: {n_cmp} "
                  f"kernel/plain comparisons agree ({n_off} bf16 elements "
                  "outside BLOCK_TOL)")
            n_cmp = check_gmm_bins(bins, g.fwd, g.bwd, tb, err)
            phase("kernels", f"{name} MoNet K={k} F={f}: fwd widths "
                  f"{g.fwd.widths} bwd widths {g.bwd.widths}: {n_cmp} "
                  "bin kernel/plain comparisons agree (tanh on and off)")
    # a forced block whose rows hold thousands of edges in both directions
    # (the row lists' many batches, two column tiles a chunk), from a
    # generator of its own so that the checks before and after see the
    # same numbers
    prng = np.random.default_rng(2)
    plf = hub_graph(structure, prng).to(dev)
    tol = hub_tol(plf, BLOCK_TOL)
    for h, f in DENSE_SHAPES:
        n_cmp, n_off = check_dense(dense, plf, tables(
            _gat_forward, plf, h, f, prng, dev), err, tol)
        phase("kernels", f"power-law forced block {PL_FORCED} H={h} F={f}: "
              f"fwd block {block_stats(plf.fwd)}, widest row "
              f"{widest_row(plf.fwd.dense)}; bwd block {block_stats(plf.bwd)}, "
              f"widest row {widest_row(plf.bwd.dense)}: {n_cmp} kernel/plain "
              f"comparisons agree (atol {tol['atol']:.3g}; {n_off} bf16 "
              "elements outside it)")
    for k, f in GMM_DENSE_SHAPES:
        n_cmp, n_off = check_gmm_dense(dense, plf, gmm_tables(
            plf.num_nodes, k, f, prng, dev), err, tol)
        phase("kernels", f"power-law forced block {PL_FORCED} MoNet K={k} "
              f"F={f} D={GMM_D}: {n_cmp} kernel/plain comparisons agree "
              f"(atol {tol['atol']:.3g}; {n_off} bf16 elements outside "
              "it)")
    # a block one of whose columns tops every score of the rows that miss
    # it by far more than exp's range (K5's exact row maximum), from a
    # generator of its own
    from dgnn_tpu_torch.data.synthetic import rmat_edges
    pg, node = planted_graph(structure, dense, rmat_edges)
    pg = pg.to(dev)
    n_cmp, miss, least = check_planted(dense, pg, node,
                                       np.random.default_rng(4), dev, err)
    phase("kernels", f"planted block {PLANT}: fwd block "
          f"{block_stats(pg.fwd)}, column of node {node}; {n_cmp} "
          f"kernel/plain comparisons agree, m bit for bit; {miss} rows "
          f"miss the column, least l of a row with an edge {least:.4g}")
    # a block whose long rows K7/K8 cut into pieces and merge, from a
    # generator of its own
    srng = np.random.default_rng(3)
    star = star_graph(structure, srng).to(dev)
    tol = row_tol(star, BLOCK_TOL)
    for k, f in ((2, 64), (3, 7)):  # 8 columns a lane (reddit's); 1
        n_cmp, n_off, lists = check_gmm_cut(dense, star, gmm_tables(
            star.num_nodes, k, f, srng, dev), err, tol)
        cut = "; ".join(
            f"{way} block {block_stats(adj)}: {wl.num_pieces} pieces, "
            f"{wl.split_rows} rows cut, budget {wl.budget}, "
            f"{wl.split_share:.3f} of the edges in cut rows"
            for way, adj, wl in zip(("fwd", "bwd"), (star.fwd, star.bwd),
                                    lists))
        phase("kernels", f"star block {STAR} MoNet K={k} F={f} D={GMM_D}, "
              f"work lists: {cut}: {n_cmp} kernel/plain comparisons agree "
              f"(atol {tol['atol']:.3g}; {n_off} bf16 elements outside "
              "it), one merge a launch, a second launch equal bit for bit")
    ec_study = load_script("exp_ec_tiles_torch")
    gather_study = load_script("microbench_gather_torch")
    for what, n_cmp in check_masked_max(ec_tiles, ec_study.make_inputs, dev,
                                        err):
        phase("kernels", f"masked_max {what}: {n_cmp} kernel/plain "
              "comparisons equal, both schedules, index included, and the "
              "list pass's live counts")
    for what in check_tie_sum(ec_tiles, edgeconv, dev, err):
        phase("kernels", f"tie_sum_bwd {what}: the kernel matches "
              "_dsrc_ties on CPU copies (f32: rtol "
              f"{EC_F32_TOL['rtol']}, atol {EC_F32_TOL['atol']}; bf16: rtol "
              f"{EC_BF16_TOL['rtol']}, atol {EC_BF16_TOL['atol']}), two "
              "calls equal bit for bit, one launch a call")
    done = check_gathers(gather, gather_study, dev, err)
    phase("kernels", "gather_rows_sum (rtol 1e-5, atol 8 W 2^-23) and "
          f"gather_lanes (exact) agree with their plain versions: {done}")
    phase("kernels", f"max |kernel - plain|: {json.dumps(err)}")

    # 4. the op on the card against the op on CPU copies
    cora = hubs["cora"]
    cases = [("pubmed", pub, p, "float32") for p in (0.0, 0.3)]
    cases += [("cora", cora, p, dt) for dt in DENSE_DTYPES for p in (0.0, 0.3)]
    for name, graph, p, dt in cases:
        h, f = SHAPES[0]
        n = graph.num_nodes
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((n, h), (n, h), (n, h, f), (n, h, f))]
        res = {}
        for where, to in (("card", dev), ("cpu", "cpu")):
            ins = [torch.from_numpy(a).to(to).requires_grad_(True)
                   for a in arrs[:3]]
            out = gat_aggregate(graph.to(to), *ins, attn_drop=p, seed=SEED,
                                training=True, dense_dtype=dt)
            out.backward(torch.from_numpy(arrs[3] * G_SCALE).to(to))
            res[where] = [out.detach().cpu()] + [t.grad.cpu() for t in ins]
        assert_close(res["card"][0], res["cpu"][0], FWD_TOL, dt, "out: ")
        for gname, a, b in zip(("ar", "ac", "feat"), res["card"][1:],
                               res["cpu"][1:]):
            assert_close(a, b, BWD_TOL, dt, f"d{gname}: ")
        phase("op", f"gat_aggregate {name} H={h} F={f} p={p} dense_dtype "
              f"{dt}: output and d(ar, ac, feat) on the card match the CPU")

    gmm_names = ("feat", "proj_weight", "proj_bias", "mu", "inv_sigma")
    for name, graph, dt in [("pubmed", pub, "float32")] + [
            ("cora", cora, dt) for dt in DENSE_DTYPES]:
        k, f = GMM_SHAPES[0]
        n = graph.num_nodes
        arrs = dict(feat=grng.normal(size=(n, k, f)),
                    proj_weight=grng.normal(size=(2, GMM_D)),
                    proj_bias=grng.normal(size=(GMM_D,)),
                    mu=grng.normal(size=(k, GMM_D)),
                    inv_sigma=grng.random((k, GMM_D)) + 0.5,
                    s=grng.normal(size=(n, 1)), d=grng.normal(size=(n, 1)),
                    g=grng.normal(size=(n, k, f)) * G_SCALE)
        arrs = {key: a.astype(np.float32) for key, a in arrs.items()}
        res = {}
        for where, to in (("card", dev), ("cpu", "cpu")):
            t = {key: torch.from_numpy(a).to(to) for key, a in arrs.items()}
            ins = {key: t[key].requires_grad_(True) for key in gmm_names}
            out = gmm_aggregate_node(
                graph.to(to), ins["feat"], t["s"], t["d"], ins["mu"],
                ins["inv_sigma"], proj_weight=ins["proj_weight"],
                proj_bias=ins["proj_bias"], dense_dtype=dt)
            out.backward(t["g"])
            res[where] = [out.detach().cpu()] + [ins[key].grad.cpu()
                                                 for key in gmm_names]
        assert_close(res["card"][0], res["cpu"][0], FWD_TOL, dt, "out: ")
        assert_close(res["card"][1], res["cpu"][1], BWD_TOL, dt, "dfeat: ")
        param_tol = dict(rtol=PARAM_TOL["rtol"],
                         atol=PARAM_TOL["atol_per_edge"] * graph.num_edges)
        worst = 0.0
        for gname, a, b in zip(gmm_names[1:], res["card"][2:],
                               res["cpu"][2:]):
            # a handful of numbers each: the bf16 flip share does not apply
            torch.testing.assert_close(
                a, b, **(param_tol if dt == "float32" else BF16_BOUND),
                msg=lambda m: f"d{gname} {name} {dt}: {m}")
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(
                min=1e-12)).max()))
        phase("op", f"gmm_aggregate_node {name} K={k} F={f} dense_dtype {dt}: "
              "output and d(feat, proj_weight, proj_bias, mu, inv_sigma) on "
              f"the card match the CPU (parameter gradients: rtol "
              f"{param_tol['rtol']}, atol {param_tol['atol']:.3g}; largest "
              f"relative difference {worst:.3g})")

    for what in check_edgeconv_op(dev, np.random.default_rng(7)):
        b, p, f = EC_OP_SHAPE
        phase("op", f"edge_conv_max_dense B={b} P={p} F={f} {what}: output "
              "equal, d(h_src, h_dst) on the card match the CPU")

    # 5. train through the trainers' entry points: cora (bin and dense
    #    kernels), then pubmed (the bin kernels), GAT then MoNet
    trainers = {"gat": load_script("train_gat_torch"),
                "gmm": load_script("train_gmm_torch")}
    titles = {"gat": "GAT heads (4,1) hidden 64 attn_drop 0.3",
              "gmm": "MoNet hidden 64 kernels 3 dim 2 dropout 0.5 lr 1e-2"}
    launches = {}
    loop_s = 0.0
    # pubmed: 3 classes, chance 1/3
    for kind, dataset, min_acc in (("gat", "cora", CORA_MIN_ACC),
                                   ("gat", "pubmed", 0.5),
                                   ("gmm", "cora", CORA_MIN_ACC),
                                   ("gmm", "pubmed", 0.5)):
        r, launches[(kind, dataset)] = run_trainer(bins, trainers[kind],
                                                   kind, dataset)
        losses = r["losses"]
        assert r["test_acc"] > min_acc, (kind, dataset, r["test_acc"])
        t0 = time.perf_counter()
        run_loop(bins, trainers[kind], kind, dataset, r, dev, smi)
        loop_s += time.perf_counter() - t0
        used = {k: v for k, v in launches[(kind, dataset)].items() if v}
        phase("train", f"{dataset} {titles[kind]}: "
              f"{r['train_steps']} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, train {r['train_s'] * 1e3:.3f} ms/step, "
              f"inference {r['infer_s'] * 1e3:.3f} ms, peak "
              f"{r['peak_mb']:.0f} MB, test acc {r['test_acc']:.4f} (> "
              f"{min_acc}), launches {used} (every other kernel 0); card "
              "logits match "
              f"a CPU copy (max |diff| {r['logit_err']:.3g}, "
              f"{r['logit_off']} of {r['logits'].numel()} outside 1e-4)")

    phase("loop", f"the loop phase took {loop_s:.1f} s")

    # MoNet's CLI default on the citation graphs (the JAX CLI's set-up):
    # binned per-edge pseudo, no hub block, plain PyTorch passes
    gmm_argv = trainers["gmm"].BENCH_ARGV
    cut = gmm_argv.index("--pseudo")
    binned_argv = gmm_argv[:cut] + gmm_argv[cut + 2:]
    r, launches[("gmm", "pubmed binned")] = run_trainer(
        bins, trainers["gmm"], "gmm", "pubmed", argv=binned_argv)
    assert r["pseudo_mode"] == "binned" and r["graph"].fwd.dense is None
    assert r["test_acc"] > 0.5, r["test_acc"]
    phase("train", f"pubmed {titles['gmm']}, binned pseudo (the CLI's "
          f"default): {r['train_steps']} steps, loss {r['losses'][0]:.4f} "
          f"-> {r['losses'][-1]:.4f}, train {r['train_s'] * 1e3:.3f} "
          f"ms/step, inference {r['infer_s'] * 1e3:.3f} ms, peak "
          f"{r['peak_mb']:.0f} MB, test acc {r['test_acc']:.4f} (> 0.5), no "
          "kernel launched (its passes are plain PyTorch); card logits "
          f"match a CPU copy (max |diff| {r['logit_err']:.3g})")
    del r

    t0 = time.perf_counter()
    rmat_numpy_s = run_reddit(bins, dense, trainers, titles, launches,
                              REDDIT_SCALE, dev, smi)
    phase("reddit", f"the reddit and memory phases took "
          f"{time.perf_counter() - t0:.1f} s (host builds included)")

    ec_trainer = load_script("train_edgeconv_torch")
    r, launches[("edgeconv",)] = run_edgeconv_trainer(ec_trainer)
    losses = r["losses"]
    used = {k: v for k, v in launches[("edgeconv",)].items() if v}
    phase("train", f"modelnet (synthetic) DGCNN B={EC_B} P={EC_P} k={EC_K} "
          f"dims {[f for _, f in EC_LAYERS]}: {r['train_steps']} steps (2 "
          f"epochs of {r['steps_per_epoch']} by run_epochs, the rest the "
          f"timing copy's) + {r['eval_batches']} eval batches, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (last epoch's mean "
          f"{r['epoch_loss']:.4f}, train acc {r['epoch_acc']:.4f}), train "
          f"{r['train_s'] * 1e3:.3f} ms an epoch ({r['step_s'] * 1e3:.3f} "
          f"ms/step, a replayed CUDA graph of the epoch), inference "
          f"{r['infer_s'] * 1e3:.3f} ms a pass over the test batches "
          f"(replayed), peak {r['peak_mb']:.0f} MB, test acc "
          f"{r['test_acc']:.4f}, lr at the end {r['last_lr']:.6g}, launches "
          f"{used} (every other kernel 0); card logits on two clouds match a "
          f"CPU copy given the card's masks (max |diff| "
          f"{r['logit_err']:.3g}; mask entries that differ per layer "
          f"{r['mask_flips']}) | {smi}")
    t0 = time.perf_counter()
    run_edgeconv_loop(ec_trainer, r, dev, smi)
    phase("loop", f"the DGCNN loop took {time.perf_counter() - t0:.1f} s")
    del r
    # the gather kernels' only path: the study script
    study_iters = 5
    reset_all_launches()
    gather_cases = gather_study.study(dev, iters=study_iters)
    launches["gather"] = all_launches()
    per_case = 1 + 2 + study_iters  # a check, the warmup, the timed calls
    # a lanes case also warms up and records a CUDA graph of its calls
    per_graph = 1 + gather_study.GRAPH_CALLS
    want = dict.fromkeys(launches["gather"], 0)
    want.update(gather_rows_sum=per_case * len(gather_study.ROWS_CASES),
                gather_lanes=(per_case + per_graph)
                * len(gather_study.LANES_CASES))
    assert launches["gather"] == want, (launches["gather"], want)
    # masked_max's "step1" schedule: the model runs "step8"; "step1" runs in
    # the masked-max study (its float32 study mask), its only path now
    reset_all_launches()
    ec_case = ec_study.study(dev, iters=study_iters)
    launches["ec_study"] = all_launches()
    per_variant = 1 + 2 + study_iters  # a check, the warmup, the timed calls
    want = dict.fromkeys(launches["ec_study"], 0)
    want.update(masked_max_step1=2 * per_variant,
                masked_max_step8=2 * per_variant,
                masked_max_live_lists=1 + (2 + study_iters)
                + 4 * per_variant)
    assert launches["ec_study"] == want, (launches["ec_study"], want)
    phase("train", f"masked-max study {ec_case['shape']}: " + ", ".join(
        f"{row['variant']} {row['ms']:.4f} ms" for row in ec_case["rows"])
        + "; launches "
        + f"{ {k: v for k, v in launches['ec_study'].items() if v} } | {smi}")
    for case in gather_cases:
        phase("train", f"gather study {case['case']}: " + ", ".join(
            f"{row['variant']} {row['ms']:.4f} ms "
            f"({row['useful_gb_per_s']:.0f} GB/s useful"
            + (f", {row['graph_ms']:.4f} ms in a CUDA graph"
               if "graph_ms" in row else "") + ")"
            for row in case["rows"]) + f" | {smi}")
    torch.cuda.empty_cache()

    # 6. baselines: the native graph library, the flat primitives, the
    #    naive baselines against the fused ops, checkpoints
    t0 = time.perf_counter()
    prng2 = np.random.default_rng(2)  # hub_graph's edges again
    dc = synthetic_citation("cora")
    for name, edges, dense_arg in (
            ("pubmed", (d.src, d.dst, d.num_nodes), None),
            ("cora planner block", (dc.src, dc.dst, dc.num_nodes), "auto"),
            (f"skewed forced block {PL_FORCED}", hub_edges(prng2),
             PL_FORCED)):
        calls, t_nat, t_np, n_arr = check_native(structure, native, *edges,
                                                 dense_arg)
        phase("baselines", f"native {name}: coo_to_csr, csr_to_csc_permute, "
              f"bin_fill, dense_mask_fill ({calls}) give the numpy versions' "
              f"graph, {n_arr} arrays equal; host build {t_nat:.3f} s "
              f"against {t_np:.3f} s in numpy ({native.library_path()})")
    # the native R-MAT generator at reddit's size (the port's reddit build
    # keeps the numpy generator, as the JAX package's does)
    n_r, e_r = reddit_size(1.0)
    native.reset_calls()
    t1 = time.perf_counter()
    first = native.rmat_edges(n_r, e_r)
    rmat_s = time.perf_counter() - t1
    again = native.rmat_edges(n_r, e_r)
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert native.CALLS["rmat_edges"] == 2
    assert all(int(x.min()) >= 0 and int(x.max()) < n_r for x in first)
    phase("baselines", f"native rmat_edges at reddit's size ({n_r} nodes, "
          f"{e_r} edges): {rmat_s:.2f} s a call, two calls equal; the numpy "
          f"generator took {rmat_numpy_s:.1f} s in this run's reddit phase at "
          f"scale {REDDIT_SCALE} (28 to 31 s in PERF.md §7)")
    del first, again
    brng = np.random.default_rng(3)  # the baselines' own draws
    pub_flat = structure.build_graph(d.src, d.dst, d.num_nodes, dense=None,
                                     edge_tables=True)
    worst = check_primitives(pub_flat, brng, dev)
    phase("baselines", "primitives pubmed (dense=None, edge tables) H=4 "
          "F=64: spmm, sddmm, edge_softmax, edge_transpose on the card match "
          "the CPU, out and every gradient (rtol 1e-5 / atol 1e-5; "
          f"gradients rtol 1e-4 / atol 1e-5): max |diff| {worst}")
    for line in check_naive(pub, pub_flat.to(dev), cora, brng, dev):
        phase("baselines", "naive " + line)
    for dataset in ("pubmed", "cora"):
        for impl in ("naive", "fused"):
            r, used = run_trainer(
                bins, trainers["gat"], "gat", dataset,
                argv=trainers["gat"].BENCH_ARGV + ["--impl", impl])
            used = {k: v for k, v in used.items() if v}
            phase("baselines", f"naive {dataset} {titles['gat']} --impl "
                  f"{impl}: {r['train_steps']} steps, loss "
                  f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, train "
                  f"{r['train_s'] * 1e3:.3f} ms/step, inference "
                  f"{r['infer_s'] * 1e3:.3f} ms, peak {r['peak_mb']:.0f} MB, "
                  f"test acc {r['test_acc']:.4f}, launches {used}; card "
                  f"logits match a CPU copy (max |diff| "
                  f"{r['logit_err']:.3g}) | {smi}")
            del r
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        phase("baselines", "checkpoint " + check_checkpoint(ec_trainer, dev,
                                                           tmp))
    phase("baselines", f"the phase took {time.perf_counter() - t0:.1f} s")

    # 7. sharded: the sharded path, SHARD_P ranks on the card
    launches["sharded"], shard_times = run_sharded(
        bins, dense, structure, _gat_forward, dev, smi, err, time_calls,
        gather_study.graph_ms)
    torch.cuda.empty_cache()

    # 8. times: kernel and plain, in turns.  One job per (kernel, shape):
    #    (what it ran on, kernel call, plain call, input tensors, edges,
    #    feature columns, heads or Gaussian kernels).  The bin kernels one
    #    call over every bin, float32 and bf16 rows (the reddit path's
    #    instances), on pubmed; the dense kernels on cora's hub block
    def at(kind, a, f):
        return (f"H={a} F={f} p=0.3" if kind == "gat"
                else f"K={a} F={f} D={GMM_D} tanh")

    jobs = {}
    for kind, shapes, tbs in (("gat", SHAPES, tabs),
                              ("gmm", GMM_SHAPES, gmm_tabs)):
        for a, f in shapes:
            for rows, note in ((torch.float32, ""),
                               (torch.bfloat16, " bf16 rows")):
                what = f"pubmed all bins {at(kind, a, f)}{note} (one launch)"
                for name, job in path_jobs(bins, dense, kind, pub,
                                           tbs[(a, f)], rows).items():
                    jobs[(name, a, f)] = (what, *job, a * f, a)
    for kind, shapes, tbs in (("gat", DENSE_SHAPES, cora_tabs),
                              ("gmm", GMM_DENSE_SHAPES, cora_gmm_tabs)):
        for a, f in shapes:
            what = f"cora hub block {at(kind, a, f)} bf16"
            for name, job in path_jobs(bins, dense, kind, cora, tbs[(a, f)],
                                       torch.float32).items():
                if name.startswith("dense"):
                    jobs[(name, a, f)] = (what, *job, a * f, a)
    # the bin kernels one launch a bin, the way they ran before the list
    # kernels, beside one launch for every bin: (per-bin loop, list call)
    per_bin = {}
    ks = card_seed(tabs[SHAPES[0]]["ac"])  # the kernels' seed: from the card
    fkw = dict(slope=SLOPE, with_pos=True, p=0.3, seed=ks)
    bkw = dict(slope=SLOPE, p=0.3, seed=ks)
    for h, f in SHAPES:
        tb = tabs[(h, f)]
        fwd_args = [(tb["feat"], tb["ac"], tb["ar"], nbr, row, count)
                    for _w, nbr, _e, row, count in pub.fwd.bins()]
        bwd_args = [(*(tb[k_] for k_ in GAT_BWD_KEYS), nbr, row, count)
                    for _w, nbr, _e, row, count in pub.bwd.bins()]
        per_bin[("bin_gat_fwd", h, f)] = (
            lambda a=fwd_args: [bins.bin_gat_fwd(*x, **fkw) for x in a],
            jobs[("bin_gat_fwd", h, f)][1])
        per_bin[("bin_gat_bwd", h, f)] = (
            lambda a=bwd_args: [bins.bin_gat_bwd(*x, **bkw) for x in a],
            jobs[("bin_gat_bwd", h, f)][1])
    for k, f in GMM_SHAPES:
        tb = gmm_tabs[(k, f)]
        fwd_args = [gmm_bin_args(tb, nbr, row, count)[0]
                    for _w, nbr, _e, row, count in pub.fwd.bins()]
        bwd_args = [gmm_bin_args(tb, nbr, row, count)[1]
                    for _w, nbr, _e, row, count in pub.bwd.bins()]
        per_bin[("bin_gmm_node_fwd", k, f)] = (
            lambda a=fwd_args: [bins.bin_gmm_node_fwd(*x, use_tanh=True)
                                for x in a],
            jobs[("bin_gmm_node_fwd", k, f)][1])
        per_bin[("bin_gmm_node_bwd", k, f)] = (
            lambda a=bwd_args: [bins.bin_gmm_node_bwd(*x, use_tanh=True)
                                for x in a],
            jobs[("bin_gmm_node_bwd", k, f)][1])

    times = {}
    for key, (what, fn_kernel, fn_plain, inputs, edges, cols, groups) in \
            jobs.items():
        ms, plain_ms = time_pair(fn_kernel, fn_plain, time_calls, dev)
        host = ""
        if key in per_bin or key[0].startswith("dense") \
                or key[0].endswith("_bf16"):
            # a list call, or a call over cora's hub block, is shorter on the
            # card than the host takes to launch it: its time is read from a
            # replayed CUDA graph (dense_gat_fwd's holds the wrapper's two
            # launches of the columns' max of ac too, timed alone below)
            host = f" ({ms:.4f} ms a call from the host)"
            ms = gather_study.graph_ms(fn_kernel, dev, 10)
        bound_ms, bound_by = bound(key[0], inputs, flat(fn_kernel()), edges,
                                   cols, groups)
        times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
        phase("times", f"{key[0]} {what}: kernel {ms:.4f} ms{host}, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({edges} edges), no single library call | {smi}")

    # the bin kernels a pubmed training step: one call a layer, beside the
    # sum of the layers' bounds; and one launch a bin against one for every
    # bin; the bf16 instances' step beside the float32 one's
    for name, shapes in (("bin_gat_fwd", SHAPES), ("bin_gat_bwd", SHAPES),
                         ("bin_gmm_node_fwd", GMM_SHAPES),
                         ("bin_gmm_node_bwd", GMM_SHAPES)):
        step_ms = sum(times[(name, *sh)]["ms"] for sh in shapes)
        step_bound = sum(times[(name, *sh)]["bound_ms"] for sh in shapes)
        bf_ms = sum(times[(name + "_bf16", *sh)]["ms"] for sh in shapes)
        bf_bound = sum(times[(name + "_bf16", *sh)]["bound_ms"]
                       for sh in shapes)
        loop_ms = [[gather_study.graph_ms(fn, dev, 10)
                    for fn in per_bin[(name, *sh)]] for sh in shapes]
        phase("times", f"{name} a pubmed training step, layers {shapes}, "
              f"on the card (a replayed CUDA graph): {step_ms:.4f} ms "
              f"against a bound of {step_bound:.5f} ms "
              f"({step_ms / step_bound:.1f} times it); bf16 rows "
              f"{bf_ms:.4f} ms against {bf_bound:.5f} ms "
              f"({bf_ms / bf_bound:.1f} times it); one launch a bin "
              f"against one for every bin: "
              + ", ".join(f"{sh} {a:.4f} / {b:.4f} ms"
                          for sh, (a, b) in zip(shapes, loop_ms))
              + f" | {smi}")

    # the dense kernels a cora training step, both layers at their widths,
    # beside the sum of the layers' bounds
    tb = cora_tabs[DENSE_SHAPES[0]]
    colmax_ms = gather_study.graph_ms(
        lambda: dense._col_max(tb["ac"], cora.fwd.dense), dev, 10)
    for name, shapes in (("dense_gat_fwd", DENSE_SHAPES),
                         ("dense_gat_bwd", DENSE_SHAPES),
                         ("dense_gmm_fwd", GMM_DENSE_SHAPES),
                         ("dense_gmm_bwd", GMM_DENSE_SHAPES)):
        step_ms = sum(times[(name, *sh)]["ms"] for sh in shapes)
        step_bound = sum(times[(name, *sh)]["bound_ms"] for sh in shapes)
        extra = (f"; of it the columns' max of ac, {colmax_ms:.4f} ms a "
                 "layer alone" if name == "dense_gat_fwd" else "")
        phase("times", f"{name} a cora training step, layers {shapes}, on "
              f"the card (a replayed CUDA graph): "
              + " + ".join(f"{times[(name, *sh)]['ms']:.4f}" for sh in shapes)
              + f" = {step_ms:.4f} ms against a bound of {step_bound:.5f} ms "
              f"({step_ms / step_bound:.1f} times it){extra} | {smi}")

    # the EdgeConv and gather kernels, one job at a time (their inputs are
    # large): F = 256 first, the width the kernels' line reports
    for f in (256, 128, 64):
        mask, hs = ec_study.make_inputs(dev, EC_B, EC_P, f, EC_K, "knn",
                                        seed=8)
        admitted = int((mask == 0).sum())

        def live_plain():
            return ec_tiles.live_candidates(mask, hs).sum(
                dim=-1, dtype=torch.int32)

        fns = [lambda: ec_tiles.masked_max_plain(mask, hs), live_plain,
               lambda: ec_tiles.live_counts(mask, hs)] + [
            lambda s_=s_: ec_tiles.masked_max(mask, hs, schedule=s_)
            for s_ in ec_tiles.SCHEDULES]
        plain_ms, live_plain_ms, live_ms, *kernel_ms = time_turns(
            fns, time_calls, dev, [2, 5, 20, 20, 20])
        want = fns[0]()
        counts = fns[2]()
        assert torch.equal(counts, live_plain()), ("live counts", f)
        # the list pass writes a count a row and 8 bytes a live candidate
        listed = torch.empty((admitted, 2), dtype=torch.int32, device=dev)
        bound_ms, bound_by = bound("masked_max_live_lists", [mask, hs],
                                   [counts, listed], mask.numel(), 1, 1)
        times[("masked_max_live_lists", f)] = dict(
            ms=live_ms, plain_ms=live_plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
        phase("times", f"masked_max_live_lists B={EC_B} P={EC_P} F={f} knn "
              f"mask bf16: kernels (hs ranges + lists) {live_ms:.4f} ms, "
              f"plain {live_plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
              f"{bound_by}; {float(counts.float().mean()):.2f} live a row, "
              f"{int((counts < 0).sum())} rows over the cap of "
              f"{ec_tiles.LIVE_CAP}, no single library call | {smi}")
        del listed
        for i, (schedule, ms) in enumerate(zip(ec_tiles.SCHEDULES,
                                               kernel_ms)):
            name = "masked_max_" + schedule
            # at the main path's own batch too: exactly the plain version
            assert torch.equal(fns[3 + i](), want), (name, f)
            bound_ms, bound_by = bound(name, [mask, hs], [want], admitted,
                                       f, 1)
            times[(name, f)] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=None)
            phase("times", f"{name} B={EC_B} P={EC_P} F={f} knn mask bf16 "
                  f"({admitted / (EC_B * EC_P):.1f} admitted a row): kernels "
                  f"{ms:.4f} ms, the list pass {live_ms:.4f} ms of it "
                  f"({admitted * f / ms / 1e6:.0f} G admitted "
                  f"candidate-channels/s), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms by {bound_by} (operations: "
                  f"{2 * admitted * f / 1e9:.3f} G admitted of "
                  f"{2 * EC_B * EC_P * EC_P * f / 1e9:.1f} G dense), no "
                  f"single library call | {smi}")
        # the tie-sum backward at this layer's width, on the max it saves:
        # the wrapper (list pass + sum) from the host and from a replayed
        # CUDA graph, beside its plain version on the card (torch ops and a
        # torch.nonzero) and held to it there too, bit for bit; its list
        # pass alone, beside that pass's plain version
        g_t = torch.randn(hs.shape, generator=torch.Generator(
            device=dev).manual_seed(15), device=dev) * G_SCALE
        tie_fns = [lambda: edgeconv._dsrc_ties(want, mask, hs, g_t,
                                               torch.bfloat16),
                   lambda: edgeconv.tie_sum_bwd(want, mask, hs, g_t),
                   lambda: edgeconv.tie_lists_plain(want, mask, hs),
                   lambda: edgeconv._tie_lists(want, mask, hs)]
        tie_plain_ms, tie_host_ms, lists_plain_ms = time_turns(
            tie_fns[:3], time_calls, dev, [3, 20, 2])
        tie_ms = gather_study.graph_ms(tie_fns[1], dev, 5)
        lists_ms = gather_study.graph_ms(tie_fns[3], dev, 5)
        tie_out = tie_fns[1]()
        assert torch.equal(tie_out, tie_fns[0]()), ("tie_sum_bwd", f)
        bounds, _, count = tie_fns[3]()
        # the pairs its filter keeps: what the function has to test, and
        # what the list pass writes (8 bytes a listed pair)
        pairs = int(count.sum())
        listed = torch.empty((int(count.clamp(max=edgeconv.TIE_CAP).sum()),
                              2), dtype=torch.int32, device=dev)
        bound_ms, bound_by = bound("tie_sum_bwd", [mask, want, hs, g_t],
                                   [tie_out], pairs, f, 1)
        times[("tie_sum_bwd", f)] = dict(ms=tie_ms, plain_ms=tie_plain_ms,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=None)
        lists_bound_ms, lists_by = bound(
            "tie_sum_lists", [mask, want, hs], [bounds, count, listed],
            mask.numel(), 1, 1)
        times[("tie_sum_lists", f)] = dict(
            ms=lists_ms, plain_ms=lists_plain_ms, bound_ms=lists_bound_ms,
            bound_by=lists_by, library_ms=None)
        phase("times", f"tie_sum_bwd B={EC_B} P={EC_P} F={f} knn mask bf16, "
              f"mul_dtype bfloat16 ({pairs / (EC_B * EC_P):.1f} pairs a "
              f"column pass its filter, the largest count {int(count.max())}"
              f", {int((count > edgeconv.TIE_CAP).sum())} columns over the "
              f"lists' cap): {tie_ms:.4f} ms a call in a replayed CUDA graph "
              f"(list pass + sum; {tie_host_ms:.4f} ms from the host), plain "
              f"{tie_plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({tie_ms / bound_ms:.1f} times it), no single library call; "
              f"the list pass alone {lists_ms:.4f} ms (plain "
              f"{lists_plain_ms:.4f} ms, bound {lists_bound_ms:.5f} ms by "
              f"{lists_by}, {lists_ms / lists_bound_ms:.1f} times it) | "
              f"{smi}")
        del g_t, tie_fns, tie_out, bounds, count, listed
        # the op around the kernel, forward + backward, in both backward
        # modes: "tie_sum" (the default, as the JAX op's) sums g over the
        # tied sources (tie_sum_bwd); "argmax" has the kernel save the first
        # winner and scatters g to it
        a, b = (t.requires_grad_(True) for t in (hs, torch.zeros_like(hs)))
        g_out = torch.ones_like(hs)

        def ec_step(bwd_mode):
            edge_conv_max_dense(mask, a, b, bwd_mode=bwd_mode).backward(g_out)

        tie_ms, arg_ms = time_turns(
            [lambda: ec_step("tie_sum"), lambda: ec_step("argmax")],
            time_calls, dev, [10, 10])
        phase("times", f"edge_conv_max_dense fwd+bwd B={EC_B} P={EC_P} F={f} "
              f"mul_dtype bfloat16: tie_sum {tie_ms:.4f} ms, argmax "
              f"{arg_ms:.4f} ms | {smi}")
        del mask, hs, fns, want, counts, a, b, g_out
    # the tie-sum backward a DGCNN step: one call a layer, widths 64, 64,
    # 128 and 256, beside the sum of the layers' bounds
    widths = [f for _, f in EC_LAYERS]
    tie_step = sum(times[("tie_sum_bwd", f)]["ms"] for f in widths)
    tie_bound = sum(times[("tie_sum_bwd", f)]["bound_ms"] for f in widths)
    lists_step = sum(times[("tie_sum_lists", f)]["ms"] for f in widths)
    phase("times", f"tie_sum_bwd a DGCNN step, layers {widths}: "
          + " + ".join(f"{times[('tie_sum_bwd', f)]['ms']:.4f}"
                       for f in widths)
          + f" = {tie_step:.4f} ms against a bound of {tie_bound:.5f} ms "
          f"({tie_step / tie_bound:.1f} times it), the list passes "
          f"{lists_step:.4f} ms of it; plain "
          f"{sum(times[('tie_sum_bwd', f)]['plain_ms'] for f in widths):.4f}"
          f" ms | {smi}")
    for width, sub in ((64, 8), (32, 8), (256, 8), (64, 2)):
        feat, nbr = gather_study.rows_inputs(dev, sub=sub, width=width,
                                             seed=9)
        # the same call on a table of L2_ROWS rows, which the L2 holds
        # whole, so that every repeat is an L2 hit
        feat_l2, nbr_l2 = gather_study.rows_inputs(
            dev, n=L2_ROWS, sub=sub, width=width, seed=9)
        nbr_long = nbr.long()
        fns = [lambda: gather.gather_rows_sum_plain(feat, nbr),
               lambda: gather_study.rows_library(feat, nbr_long),
               lambda: gather.gather_rows_sum(feat, nbr),
               lambda: gather.gather_rows_sum(feat_l2, nbr_l2)]
        plain_ms, library_ms, ms, l2_ms = time_turns(
            fns, time_calls, dev, [10, 10, 20, 20])
        torch.testing.assert_close(
            fns[3](), gather.gather_rows_sum_plain(feat_l2, nbr_l2),
            **gather_study.rows_tol(width))
        # what the function must move: each distinct named row of the table
        # once (a row named again need not be fetched again), the ids, the
        # output.  Beside it the all-miss traffic: every named row fetched
        # from device memory, repeats included.
        distinct = int(torch.unique(nbr).numel())
        bound_ms, bound_by = bound("gather_rows_sum",
                                   [(feat, distinct), nbr], [fns[2]()],
                                   nbr.numel(), sub * 128, 1)
        all_miss_ms, _ = bound("gather_rows_sum", [(feat, nbr.numel()), nbr],
                               [fns[2]()], nbr.numel(), sub * 128, 1)
        gathered = nbr.numel() * sub * 512  # bytes of the named rows
        l2_tb_s = gathered / l2_ms / 1e9
        times[("gather_rows_sum", width, sub)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, l2_resident_ms=l2_ms,
            l2_resident_tb_per_s=l2_tb_s)
        phase("times", f"gather_rows_sum {nbr.numel()} rows of "
              f"{sub * 128 * 4} bytes in segments of {width}: kernel "
              f"{ms:.4f} ms ({gathered / ms / 1e6:.0f} GB/s "
              f"useful), plain {plain_ms:.4f} ms, embedding_bag "
              f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({distinct} distinct rows; kernel {ms / bound_ms:.1f} times "
              f"above it; all-miss traffic {all_miss_ms:.5f} ms); on a "
              f"table the L2 holds whole (the same ids into {L2_ROWS} rows) "
              f"{l2_ms:.4f} ms, {l2_tb_s:.3f} TB/s of gathered rows (kernel "
              f"{ms / l2_ms:.2f} times that) | {smi}")
        del feat, nbr, nbr_long, fns, feat_l2, nbr_l2
    for c in (2048, 512, 1024, 4096):
        tab, idx = gather_study.lanes_inputs(dev, c, seed=10)
        idx_wide = idx.repeat(1, tab.shape[1] // idx.shape[1]).long()
        fns = [lambda: gather.gather_lanes_plain(tab, idx),
               lambda: gather_study.lanes_library(tab, idx_wide),
               lambda: gather.gather_lanes(tab, idx)]
        plain_ms, library_host_ms, host_ms = time_turns(
            fns, time_calls, dev, [20, 20, 20])
        # at these sizes a call is shorter on the card than the host takes
        # to launch it: the kernel's and the library call's time are read
        # from a replayed CUDA graph of 20 calls, the host's beside them
        library_ms = gather_study.graph_ms(fns[1], dev, 10)
        ms = gather_study.graph_ms(fns[2], dev, 10)
        bound_ms, bound_by = bound("gather_lanes", [tab, idx], [fns[2]()],
                                   idx.numel(), 1, 1)
        times[("gather_lanes", c)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms)
        phase("times", f"gather_lanes table {c} x {tab.shape[1]} (slab "
              f"{gather.lane_slab_width(c, tab.shape[1])} columns), "
              f"{idx.shape[0]} rows of {idx.shape[1]} lanes: kernel "
              f"{ms:.4f} ms ({bound_ms * PEAK_BYTES_S / 1e9 / ms:.0f} GB/s of "
              f"what must move; {host_ms:.4f} ms a call launched from the "
              f"host), plain {plain_ms:.4f} ms, torch.gather "
              f"{library_ms:.4f} ms ({library_host_ms:.4f} ms from the "
              f"host), bound {bound_ms:.5f} ms by {bound_by} | {smi}")
        del tab, idx, idx_wide, fns
    torch.cuda.empty_cache()

    cora_binned = structure.build_graph(dc.src, dc.dst, dc.num_nodes,
                                        dense=None, edge_tables=False).to(dev)
    n = cora.num_nodes
    h, f = DENSE_SHAPES[0]
    ins = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
           .requires_grad_(True) for s in ((n, h), (n, h), (n, h, f))]
    g_out = torch.from_numpy(
        rng.normal(size=(n, h, f)).astype(np.float32) * G_SCALE).to(dev)

    def step(graph):
        out = gat_aggregate(graph, *ins, attn_drop=0.3, seed=SEED,
                            training=True)
        out.backward(g_out)

    auto_ms, binned_ms = time_pair(lambda: step(cora), lambda: step(
        cora_binned), time_calls, dev)
    layouts = (f"hub block (dense=auto, bins {cora.fwd.widths}/"
               f"{cora.bwd.widths}) {{:.4f}} ms, all-binned (bins "
               f"{cora_binned.fwd.widths}/{cora_binned.bwd.widths}) {{:.4f}} "
               f"ms | {smi}")
    phase("times", f"gat_aggregate fwd+bwd cora H={h} F={f} p=0.3: "
          + layouts.format(auto_ms, binned_ms))
    k, f = GMM_DENSE_SHAPES[0]
    tb = cora_gmm_tabs[(k, f)]
    gins = {key: tb[key].clone().requires_grad_(True)
            for key in ("feat", "mu", "isig")}
    pw = torch.from_numpy(grng.normal(size=(2, GMM_D)).astype(np.float32)) \
        .to(dev).requires_grad_(True)
    pb = torch.zeros(GMM_D, device=dev, requires_grad=True)

    def gmm_step(graph):
        out = gmm_aggregate_node(graph, gins["feat"], tb["sfeat"],
                                 tb["dfeat"], gins["mu"], gins["isig"],
                                 proj_weight=pw, proj_bias=pb)
        out.backward(tb["g"])

    auto_ms, binned_ms = time_pair(lambda: gmm_step(cora), lambda: gmm_step(
        cora_binned), time_calls, dev)
    phase("times", f"gmm_aggregate_node fwd+bwd cora K={k} F={f} D={GMM_D}: "
          + layouts.format(auto_ms, binned_ms))
    # the card's memory rate: a 1 GiB device-to-device copy reads and writes
    # 1 GiB each
    src = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_s = time_calls(lambda: dst.copy_(src), dev, iters=10, warmup=2)
    phase("times", f"device copy 1 GiB: {copy_s * 1e3:.4f} ms, "
          f"{2 * 2 ** 30 / copy_s / 1e12:.3f} TB/s read + write (published "
          f"peak {PEAK_BYTES_S / 1e12} TB/s) | {smi}")
    del src, dst

    times.update(shard_times)  # the gid kernels, timed on a shard's layout
    report = []
    for name, meta in KERNELS.items():
        # the kernel's first job: the hidden layer's width (GAT, MoNet), the
        # widest layer (masked max, tie-sum backward), the study's default
        # shape (gathers)
        first = next(key for key in times if key[0] == name)
        # launches: the cora run of the kernel's model, the path that runs
        # its bin and its dense kernels; the DGCNN run (masked max "step8"
        # and its list pass, the tie-sum backward); the studies (masked max
        # "step1", the gathers)
        # the bf16 instances: the reddit run of their model (bf16 gathers)
        if name in ("masked_max_live_lists", "masked_max_step8",
                    "tie_sum_bwd", "tie_sum_lists"):
            run = ("edgeconv",)
        elif name == "masked_max_step1":
            run = "ec_study"
        elif name.startswith("gather"):
            run = "gather"
        elif name.endswith("_gid"):
            run = "sharded"
        else:
            run = ("gat" if "gat" in name else "gmm",
                   "reddit" if name.endswith("_bf16") else "cora")
        report.append(dict(name=name, **meta, launches=launches[run][name],
                           max_abs_err=err[name], **times[first]))
        assert report[-1]["launches"] > 0, name
    print(json.dumps({"kernels": report}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
