#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fastegnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi); TF32 off; build the CUDA
   kernels from ``fastegnn_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds;
2. every kernel against its plain PyTorch version on the same CUDA tensors,
   at the shapes its path gives it (the 8000-node Water-3D-shaped graph,
   seed 0): the edge block forward and backward in f32 and bf16, and the
   segment-sum over ``[E, H + 3]`` rows in its dst form (f32 and bf16 data)
   and its src form (through ``src_perm``, f32): errors, median kernel,
   plain and library times over CUDA events, and the bound derived from
   this run's inputs;
3. a small input: the model on the card (kernels) against the model on the
   CPU (plain versions), f32 for FastEGNN's fused layer and attention layer,
   FastRF, FastSchNet, FastTFN, VNEGNN, the baselines EGNN, GNN, RF,
   Linear, SchNet and EGHN (these on a small protein chain with its bonds),
   GVP, DimeNet and DimeNet++ (these two with the graph's triplet table and
   their last linears scaled so that the largest output is 1), the TFN
   family (the CLIs' TFN, OurDynamics at nf = 32; its se3_transformer kind;
   the pooled TFN and SE3Transformer) (1e-4), bf16 for the fused layer
   (2e-2);
4. the main path: FastEGNN (H=64, C=3, L=4, gravity, bf16) trained with
   Adam(5e-4, 1e-12) and MMD (sigma 1, weight 0.01, sample 3, per graph) on
   the 8000-node graph, 3 warm-up + 20 timed steps, with the kernels' launch
   counts set to 0 just before and read just after; then a short
   torch.profiler window over 3 more steps;
5. the variant path: the same configuration with ``attention=True`` in f32
   (the CLI's ``--attention_required`` off the TPU), whose edge block takes
   the CSR branch and its segment-sum kernel, run and read the same way;
6. the graph-parallel path ``[gp]`` (``gp_phase``) on the main path's
   graph in f32: (a) two gloo ranks on the card, each holding its 4000
   owned rows and its halo table (``parallel/owner_graph.py``), against
   one process: the f32 and bf16 forwards, two train steps on the same MMD
   draws, 4 + 4 f32 edge launches per rank step; S, the halo bytes per
   layer, the ``all_to_all``'s and the steps' ms; then the f32 edge
   kernels against their plain versions on rank 0's table (a src table
   longer than its dst rows); (b) a one-rank NCCL group: the owner step
   against the plain step, both timed, then a profiler window over each;
   then the weak-scaling sweep ``[scaling]`` (``scaling_phase``,
   ``scripts/torch_bench_scaling.py`` in its own ``torchrun`` worlds): G =
   1 over NCCL at the JAX script's defaults (512 nodes per shard of its
   Morton-ordered cube graph, 2 layers, 10 timed steps) and at the main
   path's size and depth (8000 nodes per shard, 4 layers), then G = 2 gloo
   ranks sharing the card at 512 nodes per shard (a harness check, not a
   scaling number); each line's edges and halo fields against the JAX
   script's, L + L f32 edge launches per rank step on every rank; then the
   f32 edge kernels against their plain versions on every rank's table of
   every run;
7. the CLI path: ``cli.common.run_training`` with the Water-3D CLI's
   defaults (f32, so the f32 edge kernels; batch 20; ``--virtual_channel 3
   --cutoff_rate 0.5``, and ``--radius 0.075`` for Water-3D's mean degree),
   3 epochs on the synthetic Water-3D trajectories (3 per split, 8000
   particles, built in memory: a GPU machine need not have h5py), after
   ``[collate]`` (``collate_phase``: one batch of the train split collated
   on the host from the dataset's per-graph edge tables, the main path's
   collate, and by the plain collate ``graph.batch_graphs_plain``, each
   timed, the two batches equal field for field; the tables' build
   seconds), with exact launch counts, per-epoch telemetry, and a resume from the best
   checkpoint that restores it tensor for tensor and trains one more epoch
   under the profiler (the epoch's busy share); then a profiler window over
   its train step, and the f32 edge kernels against their plain versions
   on that step's 20-graph batch;
8. the rollout: ``train.rollout.make_rollout`` over 5 steps on one test
   graph of the trained model, 4 forward launches per step; then the f32
   edge kernels against their plain versions on that graph;
9. the N-body path: the port's generator writes ``100_0_0`` (100
   trajectories per split, 4100 steps, a spawned worker per CPU) and
   ``[collate]`` on its train split; on the
   first batch of its train split the data-parallel path ``[dp]``
   (``dp_phase``: two gloo ranks on the card, each on its half, against
   one process on the whole batch; a one-rank NCCL group's DP step against
   the plain step with the MMD term on, both timed); then ``[options]``
   (``options_phase``): the constructor options no CLI sets at H=64, C=3,
   L=4, FastEGNN with ``residual=False`` and the charges as node
   attributes in f32 and in bf16, VNEGNN and FastSchNet with both, FastTFN
   with ``residual=False``: each on [small]'s batch against the CPU (1e-4
   f32, 2e-2 bf16), then 3 train steps on that batch with exact launch
   counts and finite losses; then the f32 edge kernels and FastSchNet's
   segment-sum forms against their plain versions on it; then the
   N-body CLI's ``run_training`` trains on it at ``run_nbody.sh``'s
   configuration (f32, batch 100, ``--cutoff_rate 0.5``, sigma 1.5, weight
   0.01, seed 43, the shared MMD draw) for 2 epochs with exact launch
   counts; then 3 warm-up + 20 timed train steps on one batch (10,000
   nodes, 495,000 edges), a profiler window, and the f32 edge kernels
   against their plain versions on that batch. Then the same CLI run,
   timed steps and profiler window with ``--model FastRF`` (the f32 edge
   kernels, whose ``m_sum`` FastRF does not use), ``--model FastSchNet``
   and ``--model FastTFN`` (the segment-sum kernel in the four forms each
   path launches, FastTFN's with the TFN's sum at src over ``[E, 3]``,
   held against its plain version on that batch) and ``--model VNEGNN``
   (the f32 edge kernels in its A2A cells, held against their plain
   versions on that batch; trained without the MMD term), on the same
   trajectories; then the baselines EGNN, GNN, RF, Linear and SchNet (16
   interactions), on the MSE alone, the segment-sum kernel held in the
   forms GNN and SchNet add; then GVP (the mean of ``[s | V]`` at src and
   its gathers' backwards over ``[E, 148]``), DimeNet and DimeNet++ (the
   triplets' sum at ji over ``[T, 64]`` and the perm-form sums at kj in
   the backward; T and the seconds to build the triplet table printed),
   on the MSE alone, each new form held against its plain version; then
   ``--model TFN`` (OurDynamics, nf = 32, L = 4, num_degrees 2; the MSE
   alone), its convolutions' mean at src and its gathers' backwards over
   ``[E, 128]`` held; then the se3_transformer kind of OurDynamics at the
   JAX defaults through the train step on that batch (timed steps, a
   profiler window, its softmax denominators' and weighted values' sums at
   src held);
10. the protein path: the same for the protein CLI (``run_protein.sh``:
   batch 50, sigma 1.0, weight 0.5, delta_frame 15, ``--cutoff_rate 0.5``)
   on a synthetic 856-atom chain of 270 frames (151 / 50 / 52 samples),
   ``[collate]`` on its train split and on EGHN's (with the bonds' tables),
   for the five models (VNEGNN's virtual positions from the batch's
   Fibonacci spheres), EGNN and TFN; then EGHN (n_cluster 15, 3 layers per
   block, 4 pooling layers, a 2-layer decoder) on the CLI's datasets with
   the chain's bonds, the segment-sum kernel held in its bond forms
   (through ``local_perm`` / ``local_src_perm``) and its pooled
   adjacency's;
11. the equivariance CLI on the card at 10 and 100 nodes for the five
   models and EGNN, RF, Linear, SchNet and TFN: every trial within 1e-4,
   with each model's launches;
12. the converged-parity harness ``[parity]``
   (``scripts/torch_parity_nbody.py::run_port``, the JAX harness's
   hyperparameters and loop) for 10 epochs each of FastEGNN, EGNN and
   VNEGNN on a small 5-particle set that the generator writes with a worker
   per CPU: the ``[best, log]`` JSON's shape, finite losses, epoch 10's
   train loss below epoch 1's, exact launches, the seconds per epoch; then
   the f32 edge kernels and EGNN's segment-sum forms held against their
   plain versions on one 100-graph batch of that train split (rows of ~2
   edges at the harness's cutoff, many of them empty); then the Water-3D
   matched harness (``scripts/torch_parity_simulation.py::run_port``:
   FastEGNN with gravity and the per-graph MMD draw) for 10 epochs on the
   committed protocol, with the same checks, and the f32 edge kernels held
   on its first train batch (10 graphs of 200 particles: 2000 rows, at
   most ~1300 edges, most rows empty); then the protein harness
   (``scripts/torch_parity_protein.py::run_port``: FastEGNN with the
   shared MMD draw at weight 0.5) for 5 epochs on the committed synthetic
   AdK chain, with the same checks, and the f32 edge kernels held on its
   first train batch (50 graphs of 60 atoms: 3000 rows, their 10 Angstrom
   contacts).

Phases 6 (``[gp]``, ``[scaling]``) and 9-12 print their seconds.  Output: one JSON line
``{"kernels": [...]}`` (each kernel with its launches on every path,
``[dp]``'s as ``nbody_dp_launches`` (rank 0's), ``[options]``'s over
its runs as ``nbody_options_launches`` and its checks as ``options_f32``
and ``options_FastSchNet_forms``, ``[parity]``'s as
``parity_launches`` (per model, and the Water-3D and protein runs'; the
protein run's also as ``parity_protein_launches``), ``[gp]``'s as
``gp_launches`` (rank 0's) and ``gp_nccl1_launches``, the edge kernels'
f32 checks on ``[gp]``'s table as ``gp_table_f32``, ``[scaling]``'s
launches per rank step of each run as ``scaling_launches`` and its f32
checks, by run and rank, as ``scaling_table_f32``, and
its f32 checks on the CLI batch, the rollout graph, the N-body and
protein batches and ``[parity]``'s batches (``parity_f32``,
``parity_EGNN_forms``, ``parity_water3d_f32``, ``parity_protein_f32``);
``collate``, each ``[collate]``'s figures), the
nvidia-smi line, and last ``{"ok": true, "device":
{...}}``.  Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
N_NODES, DEGREE, LAYERS, HIDDEN, CHANNELS = 8000, 60, 4, 64, 3
WARMUP, TIMED = 3, 20
KERNEL_RUNS, KERNEL_INNER = 7, 10   # median over runs of back-to-back launches
SEGSUM_F = HIDDEN + 3   # the variant path sums [m_e | trans] and grads of [h | x]
SEGSUM_TOL = 1e-5       # both versions sum in f32, possibly in another order
# the CLI path: trajectories per split, frames per trajectory, epochs
CLI_TRAJ, CLI_FRAMES, CLI_EPOCHS, ROLL_STEPS = 3, 300, 3, 5
# the synthetic particles fill their box more thinly than Water-3D's: at
# the CLI's default radius (0.035) they have ~6 real edges per node after
# the 0.5 cutoff; at 0.075, ~60, Water-3D's mean degree that the main
# path's graph has too ([cli] prints the count)
CLI_RADIUS = 0.075
# the N-body path (run_nbody.sh): 100 charged particles, one batch of 100
# graphs per split (the loop drops a short last batch, so no split can be
# smaller); the loader reads frames 30 and 40 (steps 3000 and 4000), so the
# trajectories stop at 4100 steps of the reference's 5000
NB_PARTICLES, NB_TRAJ, NB_LENGTH = 100, 100, 4100
# the protein path (run_protein.sh) on a synthetic chain of AdK's backbone
# size (214 residues x 4 atoms); 270 of its 4,187 frames: 151 / 50 / 52
# samples at delta_frame 15
PROT_ATOMS, PROT_FRAMES, PROT_SIZES = 856, 270, [151, 50, 52]
PATH_EPOCHS = 2
COLLATE_RUNS = 3   # [collate]: the median over this many collates of one batch
# the data-parallel path ([dp]): ranks on the one card, steps held against
# one process, the parameters' tolerance there (measured on the H100 at
# 700 W: 1.5e-8 where |g| >= 1e-6, 6.0e-7 over all), the ranks' time limit
DP_RANKS, DP_STEPS, DP_ATOL, DP_JOIN_S = 2, 2, 1e-6, 300
# the graph-parallel path ([gp]): ranks on the one card, each holding half
# of the main path's graph; steps held against one process; the forward's
# tolerances (of the largest value) in f32 and bf16; the ranks' time limit
GP_RANKS, GP_STEPS, GP_FWD_TOL, GP_BF16_TOL, GP_JOIN_S = 2, 2, 1e-4, 2e-2, 300
GP_STEP_KW = dict(sigma=1.0, weight=0.01, sample=3, per_graph_sampling=True)   # the main path's
# the weak-scaling sweep ([scaling]): its runs as (nodes per shard, layers,
# G, ranks per card), the JAX script's defaults and the main path's size and
# depth at G = 1 over NCCL, then two gloo ranks sharing the card; the timed
# steps; each torchrun world's time limit
SCALING_RUNS = ((512, 2, 1, 1), (N_NODES, LAYERS, 1, 1), (512, 2, 2, 2))
SCALING_ITERS, SCALING_WORLD_S = 10, 300
# the JAX script's graph and halo figures of those runs (bench_scaling.py's
# build_batch and the JAX partitioner, on the CPU): (nodes per shard, G) ->
# (real edges, S, real halo rows over all pairs)
SCALING_JAX = {(512, 1): (11056, 1, 0), (N_NODES, 1): (207770, 1, 0), (512, 2): (23552, 153, 303)}
# the converged-parity harness's phase ([parity]): the models, the 5-particle
# set's trajectories per split (one batch of the harness's 100 in each eval
# split) and the epochs (two evals at the harness's interval of 5)
PARITY_MODELS = ("FastEGNN", "EGNN", "VNEGNN")
PARITY_SIZES, PARITY_EPOCHS = dict(num_train=300, num_valid=100, num_test=100), 10
# the Water-3D matched harness's run in [parity] (two evals at its interval
# of 5), on the committed protocol and the in-memory trio
PARITY_WATER3D, PARITY_WATER3D_EPOCHS = "FastEGNN Water-3D", 10
# the protein harness's run in [parity] (one eval at its interval of 5), on
# the committed synthetic AdK chain
PARITY_PROTEIN, PARITY_PROTEIN_EPOCHS = "FastEGNN protein", 5
PARITY_RUNS = PARITY_MODELS + (PARITY_WATER3D, PARITY_PROTEIN)
# EGNN's segment-sum forms on the harness's batch: the dst mean of [f | m]
# and the backwards of the gathers of [h | x] at dst and src
PARITY_EGNN_FORMS = (("dst f32 [E, 67]", 67, False, "dst"), ("src f32 [E, 67]", 67, False, "src"))
# the port's kernels, which [profile] lists wherever they rank
OWN_KERNELS = ("edge_fwd", "edge_bwd", "segment_sum_kernel")
KERNELS = ("edge_block_fwd", "edge_block_bwd", "segment_sum")
# the models the N-body, protein and equivariance CLIs train beside FastEGNN
NEW_MODELS = ("FastRF", "FastSchNet", "FastTFN", "VNEGNN")
# the baselines of the JAX package's models/basic.py and its SchNet and EGHN:
# the N-body CLI trains the first five, the protein CLI EGNN and EGHN (EGHN
# on its bond-edge datasets), the equivariance CLI checks the equivariant
# four (GNN is not equivariant); all on the MSE alone
BASELINES = ("EGNN", "GNN", "RF", "Linear", "SchNet", "EGHN")
# GVP and DimeNet / DimeNet++ on the N-body CLI (the MSE alone), DimeNet
# reading the batch's triplet table (graph.py::build_triplets)
TRIPLET_MODELS = ("DimeNet", "DimeNet++")
# all three at the N-body CLI's batch of 100: DimeNet's reckoned peak there
# is under 60 GiB (PERF.md §5), so no batch is cut
ZOO = ("GVP",) + TRIPLET_MODELS
# the TFN family: the CLIs' --model TFN (OurDynamics at nf = 32, L = 4,
# num_degrees = 2) on the N-body, protein and equivariance CLIs; the
# SE(3)-Transformer kind of OurDynamics (no CLI flag selects it) through the
# train step on the N-body batch; the pooled TFN and SE3Transformer in
# [small] only (no CLI trains them)
TFN_NF = 32
SE3 = "se3_transformer"
SMALL_TFN_FAMILY = (SE3, "pooled TFN", "pooled SE3Transformer")
NBODY_BASELINES = ("EGNN", "GNN", "RF", "Linear", "SchNet")
# [options]: the constructor options no CLI sets, each model with those it
# has (residual=False, and the N-body charges as the node attribute), as
# (tag, model, dtype, options); OPTION_STEPS train steps on the [nbody]
# cell's first train batch
OPTIONS = dict(residual=False, node_attr_dim=1)
OPTION_RUNS = (("FastEGNN f32", "FastEGNN", "float32", OPTIONS),
               ("FastEGNN bf16", "FastEGNN", "bfloat16", OPTIONS),
               ("VNEGNN", "VNEGNN", "float32", OPTIONS),
               ("FastSchNet", "FastSchNet", "float32", OPTIONS),
               ("FastTFN", "FastTFN", "float32", dict(residual=False)))
OPTION_STEPS = 3
EQUIVARIANT_BASELINES = ("EGNN", "RF", "Linear", "SchNet")
# depths at the CLIs' configuration where it is not LAYERS: SchNet's 16
# interactions (whatever --num_layer says), EGHN's 3 EGNN layers per block
# and 4 pooling layers; in [small], 2 of each (small_model_phase's kw)
DEPTH = {"SchNet": 16, "EGHN": (3, 4)}
SMALL_DEPTH = {"SchNet": 2, "EGHN": (2, 2)}
# launches of KERNELS per layer in one forward and in one backward, for
# each model as the CLI paths run it (f32, no attention): FastEGNN, FastRF
# and VNEGNN (its A2A cell) the fused edge block; FastSchNet the
# segment-sum, forward the dst means of m_e and of the embedded SchNet's
# coordinate update, backward the gathers of [h | x] at dst and src
# (FastSchNet reads only the embedded SchNet's positions, so its CFConv
# does not run); FastTFN the segment-sum, forward the dst mean of m_e and
# the TFN's sum at src, backward the gathers of [h | x] at dst and src
# The baselines launch the segment-sum only: EGNN per layer the dst mean of
# [f | m] forward and the gathers of [h | x] at dst and src backward; GNN
# the dst mean of m forward and the gathers of h backward; RF the dst mean
# of its translations forward and the gathers of x backward; SchNet per
# interaction the dst mean of the coordinate update and the CFConv's sum at
# src forward, the gathers of [h | x] and of lin1(h) at dst backward;
# Linear none.  EGHN: expected_launches.  TFN (OurDynamics, and the pooled
# TFN) per convolution its mean at src forward and the gathers of its input
# at dst and src backward, less the first's (its input, the charges and
# velocities or the node features, needs no gradient); the
# SE(3)-Transformer: expected_launches.
PER_LAYER = {"FastEGNN": ((1, 0, 0), (0, 1, 0)), "FastRF": ((1, 0, 0), (0, 1, 0)),
             "FastSchNet": ((0, 0, 2), (0, 0, 2)), "FastTFN": ((0, 0, 2), (0, 0, 2)),
             "VNEGNN": ((1, 0, 0), (0, 1, 0)), "EGNN": ((0, 0, 1), (0, 0, 2)),
             "GNN": ((0, 0, 1), (0, 0, 2)), "RF": ((0, 0, 1), (0, 0, 2)),
             "Linear": ((0, 0, 0), (0, 0, 0)), "SchNet": ((0, 0, 2), (0, 0, 3)),
             "GVP": ((0, 0, 1), (0, 0, 2)), "TFN": ((0, 0, 1), (0, 0, 2)),
             "pooled TFN": ((0, 0, 1), (0, 0, 2))}
# DimeNet per block: the triplets' sum at ji forward; backward the
# perm-form sums at kj of the messages' gradient, one per bilinear channel
# (DimeNet) or one (++); besides, the num_blocks + 1 output blocks' sums
# at src forward and the embedding's two gathers backward
KJ_SUMS = {"DimeNet": 8, "DimeNet++": 1}
# launches a model does not make, forward and backward: FastTFN's last
# layer skips the edge MLP and its dst mean, which feed only the features
# the model discards, so the gathers of [h | x] have no backward; SchNet's
# last interaction skips its feature update (the CFConv's sum at src and
# lin1(h)'s gather); RF's first layer gathers the input coordinates, which
# need no gradient
SKIPS = {"FastTFN": ((0, 0, 1), (0, 0, 2)), "SchNet": ((0, 0, 1), (0, 0, 1)),
         "RF": ((0, 0, 0), (0, 0, 2)), "TFN": ((0, 0, 0), (0, 0, 2)),
         "pooled TFN": ((0, 0, 0), (0, 0, 2))}
# the segment-sum forms of FastSchNet's path, held against the plain
# version on its N-body and protein batches: the dst means of the
# coordinate update (diff * gate) and of m_e, and the backwards of the
# gathers of [h | x] at dst and at src
SCHNET_FORMS = (("dst f32 [E, 3]", 3, False, "dst"), ("dst f32 [E, 64]", 64, False, "dst"),
                ("dst f32 [E, 67]", 67, False, "dst"), ("src f32 [E, 67]", 67, False, "src"))
# FastTFN's: the TFN's messages summed at src, the dst mean of m_e, and
# the backwards of the gathers of [h | x]
TFN_FORMS = (("src f32 [E, 3]", 3, False, "src"), ("dst f32 [E, 64]", 64, False, "dst"),
             ("dst f32 [E, 67]", 67, False, "dst"), ("src f32 [E, 67]", 67, False, "src"))
# the baselines' forms no other path holds: GNN's gather of h at src
# backward; SchNet's CFConv, its sum at src and its gather's backward at
# dst; EGHN's bond sums at dst through local_perm ([f | 3 V] then [E, 64]
# in each pooling layer, the pooled adjacency's [E, 15]), its bond
# gathers' backwards of [h | 3 V] at dst and src, and the real edges'
# pooled adjacency at dst and its gather's backward at src.  EGNN's and
# RF's widths (67, 3) are FastSchNet's and FastTFN's on the same batches.
GNN_FORMS = (("src f32 [E, 64]", 64, False, "src"),)
SCHNET_BASELINE_FORMS = (("dst f32 [E, 128]", 128, False, "dst"),
                         ("src f32 [E, 128]", 128, False, "src"))
EGHN_FORMS = (("bond dst f32 [El, 9]", 9, False, "bond dst"),
              ("bond dst f32 [El, 64]", 64, False, "bond dst"),
              ("bond dst f32 [El, 73]", 73, False, "bond dst"),
              ("bond src f32 [El, 73]", 73, False, "bond src"),
              ("bond dst f32 [El, 15]", 15, False, "bond dst"),
              ("dst f32 [E, 15]", 15, False, "dst"), ("src f32 [E, 15]", 15, False, "src"))
# GVP's mean of [s | V] at src and its gathers' backwards at dst and src
# (100 + 16 * 3 wide); DimeNet's triplets' sum at ji (over the table's
# rowptr) and its perm-form sums at kj (DimeNet++ runs the same two forms
# on the same batch)
GVP_FORMS = (("dst f32 [E, 148]", 148, False, "dst"), ("src f32 [E, 148]", 148, False, "src"))
DIMENET_FORMS = (("ji f32 [T, 64]", 64, False, "ji"), ("kj f32 [T, 64]", 64, False, "kj"))
# TFN at nf = 32: the convolutions' mean at src of [32 | 32 x 3] and the
# backwards of their input's gathers at dst and src (the last convolution's
# mean is FastTFN's src [E, 3]); the SE(3)-Transformer's softmax
# denominators at src, its weighted values at src and the backward of the
# queries' gather at src (128 wide), and the denominators' gather (1 wide)
TFN_DYN_FORMS = (("src f32 [E, 128]", 128, False, "src"), ("dst f32 [E, 128]", 128, False, "dst"))
SE3_FORMS = (("src f32 [E, 1]", 1, False, "src"), ("src f32 [E, 128]", 128, False, "src"))
# each model's forms, held on its N-body or protein batch
PATH_FORMS = {"FastSchNet": SCHNET_FORMS, "FastTFN": TFN_FORMS, "GNN": GNN_FORMS,
              "SchNet": SCHNET_BASELINE_FORMS, "EGHN": EGHN_FORMS, "GVP": GVP_FORMS,
              "DimeNet": DIMENET_FORMS, "TFN": TFN_DYN_FORMS, SE3: SE3_FORMS}
# kernel vs plain, as max |kernel - plain| / max |plain| per output
TOL = {("fwd", False): 1e-5, ("bwd", False): 5e-5,   # f32; bwd sums with atomics
       ("fwd", True): 2e-2, ("bwd", True): 2e-2}     # bf16: one bf16 ulp can flip


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn) -> float:
    """Median ms per call over KERNEL_RUNS runs of KERNEL_INNER calls, each
    run between two CUDA events: the host enqueues the next launch while the
    card runs the last, so a wrapper's host time is not counted as kernel
    time unless it exceeds it."""
    import torch

    fn()
    times = []
    for _ in range(KERNEL_RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(KERNEL_INNER):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / KERNEL_INNER)
    return statistics.median(times)


def bound(kind: str, bf16: bool, n: int, e: int, fe: int):
    """(bound_ms, bound_by) of one kernel call: bytes each input read once and
    each output written once over the memory rate, against the chain
    products' operations over the peak rate of the compute type."""
    H = HIDDEN
    tab = 2 if bf16 else 4
    ins = 2 * n * H * tab + n * 12 + (n + 1) * 4 + e * 4 + e * fe * 4 + 136 * H * 4
    if kind == "fwd":
        nbytes = ins + n * H * 4 + n * 12
        ops = e * (2 * 2 * H * H + 2 * H * fe)
    else:
        nbytes = ins + e * 4 + n * H * 4 + n * 12 + 2 * n * H * 4 + 2 * n * 12 + 136 * H * 4
        ops = e * (6 * 2 * H * H + 2 * 2 * H * fe)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS["bfloat16" if bf16 else "float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(g, gen, modes=(False, True), tag="kernel"):
    """Each edge-block kernel against its plain version on the graph ``g``
    (phase 2: the main path's graph, f32 and bf16; the CLI path's batch and
    the rollout's graph, f32), with random tables and weights."""
    import torch

    from fastegnn_tpu_torch.ops import edge_kernel as ek

    dev = g.device
    n, e, fe = g.num_nodes, g.n_real_edges, g.edge_attr.shape[1]
    H = HIDDEN
    W1 = (torch.randn(2 * H + 1 + fe, H, generator=gen) / (2 * H) ** 0.5).to(dev)
    W2, Wg1 = ((torch.randn(H, H, generator=gen) / H ** 0.5).to(dev) for _ in range(2))
    b1, b2, bg1 = ((torch.randn(H, generator=gen) * 0.1).to(dev) for _ in range(3))
    wg2 = (torch.randn(H, 1, generator=gen) * 0.1).to(dev)
    h = torch.randn(n, H, generator=gen).to(dev)
    dms0 = torch.randn(n, H, generator=gen).to(dev)
    dts0 = torch.randn(n, 3, generator=gen).to(dev)
    results = {}
    for bf16 in modes:
        ud, us = ek.build_tables(h, W1, b1, bf16)
        wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
        dms, dts = ek._rnd(dms0, bf16).contiguous(), ek._rnd(dts0, bf16).contiguous()
        fargs = (ud, us, g.coord, g.rowptr, g.src, g.edge_attr, wpack, bf16)
        bargs = (ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr, wpack, dms, dts, bf16)
        for kind, kern, plain, args, names in (
                ("fwd", ek.edge_block_fwd, ek.edge_block_fwd_plain, fargs,
                 ("m_sum", "t_sum")),
                ("bwd", ek.edge_block_bwd, ek.edge_block_bwd_plain, bargs,
                 ("dUd", "dUs", "dx", "dw"))):
            got = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            abs_err, rel_err = 0.0, 0.0
            for name, a, b in zip(names, got, want):
                check(bool(torch.isfinite(a).all()), f"{kind} {name}: non-finite output")
                err = float((a - b).abs().max())
                rel = err / max(float(b.abs().max()), 1e-30)
                abs_err, rel_err = max(abs_err, err), max(rel_err, rel)
            ms = median_ms(lambda: kern(*args))
            plain_ms = median_ms(lambda: plain(*args))
            b_ms, b_by = bound(kind, bf16, n, e, fe)
            mode = "bf16" if bf16 else "f32"
            print(f"[{tag}] edge_block_{kind} {mode}: max_abs_err {abs_err:.3e} "
                  f"max_rel_err {rel_err:.3e} (tol {TOL[(kind, bf16)]:g}) | kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            check(rel_err <= TOL[(kind, bf16)],
                  f"{tag} edge_block_{kind} {mode}: kernel and plain disagree ({rel_err:.3e})")
            results[(kind, mode)] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            del got, want
    torch.cuda.empty_cache()
    return results


def segsum_bound(e: int, n: int, f: int, elt: int, perm: bool):
    """(bound_ms, bound_by) of one segment-sum call: the data rows, rowptr
    (and perm) read once and the f32 output written once over the memory
    rate, against one f32 add per input value over the f32 peak."""
    nbytes = e * f * elt + (n + 1) * 4 + n * f * 4 + (e * 4 if perm else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES, e * f / PEAK_OPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def segsum_phase(g, gen, forms=(("dst f32", SEGSUM_F, False, "dst"),
                                 ("dst bf16", SEGSUM_F, True, "dst"),
                                 ("src f32", SEGSUM_F, False, "src")), tag="kernel"):
    """The segment-sum kernel against its plain version on the graph ``g``
    in ``forms`` of ``(name, width, bf16, form)``: phase 2b, the three forms
    the variant path launches at its shapes; each model's forms on its
    N-body or protein batch (``PATH_FORMS``).  ``form`` is "dst" or "src"
    (the real edges over the dst CSR, or through ``src_perm``) or "bond dst"
    or "bond src" (the bond slots through ``local_perm`` or
    ``local_src_perm``, EGHN's) or "ji" or "kj" (a triplet table's rows
    summed at their ji edge over its row pointer, or at their kj edge
    through ``kj_perm``, DimeNet's)."""
    import torch

    from fastegnn_tpu_torch.ops import spmm

    n, e = g.num_nodes, g.n_real_edges
    offsets = g.rowptr.long()
    src = g.src[:e].long()
    # library yardsticks, timed only here: the dst form is a segment_reduce
    # over the row pointer, the src form an index_add_ at src in edge order,
    # a bond form an index_add_ at the bonds' ends in slot order (the batch
    # must have no padded bond slot for it to be the same sum); the ji form a
    # segment_reduce over the triplet table's row pointer, the kj form an
    # index_add_ at idx_kj in triplet order
    def by_offsets(offs):
        return lambda d: torch.segment_reduce(d, "sum", offsets=offs)

    def by_ids(ids, segments):
        return lambda d: torch.zeros(segments, d.shape[1], device=d.device).index_add_(0, ids, d)

    # form -> (rows, segments, rowptr, perm, library)
    table = {"dst": (e, n, g.rowptr, None, by_offsets(offsets)),
             "src": (e, n, g.src_rowptr, g.src_perm, by_ids(src, n))}
    if g.local_dst is not None:
        check(bool(g.local_edge_mask.all()), "bond forms: the batch has padded bond slots")
        el = g.local_dst.shape[0]
        table["bond dst"] = (el, n, g.local_rowptr, g.local_perm, by_ids(g.local_dst.long(), n))
        table["bond src"] = (el, n, g.local_src_rowptr, g.local_src_perm,
                             by_ids(g.local_src.long(), n))
    if g.triplets is not None:
        t = g.triplets
        table["ji"] = (t.num_triplets, e, t.rowptr, None, by_offsets(t.rowptr.long()))
        table["kj"] = (t.num_triplets, e, t.kj_rowptr, t.kj_perm, by_ids(t.idx_kj.long(), e))
    # the rows are drawn on the card: the triplet forms have ~28 M of them
    dgen = torch.Generator(device=g.device).manual_seed(
        int(torch.randint(2**31, (1,), generator=gen)))
    results = {}
    for name, f, bf16, form in forms:
        rows, segments, rowptr, perm, library = table[form]
        d = torch.randn(rows, f, generator=dgen, device=g.device)
        if bf16:
            d = d.bfloat16()
        got = spmm.segment_sum_csr(d, rowptr, perm)
        torch.cuda.synchronize()
        want = spmm.segment_sum_csr_plain(d, rowptr, perm)
        check(got.dtype == torch.float32 and tuple(got.shape) == (segments, f)
              and bool(torch.isfinite(got).all()), f"segment_sum {name}: bad output")
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        ms = median_ms(lambda: spmm.segment_sum_csr(d, rowptr, perm))
        plain_ms = median_ms(lambda: spmm.segment_sum_csr_plain(d, rowptr, perm))
        library_ms = median_ms(lambda: library(d))
        b_ms, b_by = segsum_bound(rows, segments, f, d.element_size(), perm is not None)
        print(f"[{tag}] segment_sum {name} [{rows}, {f}] -> [{segments}, {f}]: max_abs_err "
              f"{err:.3e} (tol {SEGSUM_TOL:g} x {top:.3e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        check(err <= SEGSUM_TOL * top,
              f"{tag} segment_sum {name}: kernel and plain disagree ({err:.3e})")
        results[name] = dict(max_abs_err=err, max_rel_err=err / max(top, 1e-30), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
        del d, got, want
    torch.cuda.empty_cache()
    return results


def launch_counts():
    from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm

    return {"edge_block_fwd": ek.FWD_LAUNCHES, "edge_block_bwd": ek.BWD_LAUNCHES,
            "segment_sum": spmm.SEGSUM_LAUNCHES}


def expected_launches(model: str, layers, train_steps: int, forwards: int) -> dict:
    """Each kernel's launches for ``train_steps`` train steps and
    ``forwards`` more forwards (eval batches, equivariance trials) of
    ``model`` with ``layers`` layers (``PER_LAYER``, less ``SKIPS``).
    EGHN's ``layers`` are ``(EGNN layers per block, pooling layers)``: per
    EGNN layer of its two blocks 1 forward and 2 backward; per pooling layer
    the two bond sums forward and the bond gathers' backwards at dst and
    src; the pooled adjacencies' sums forward (bonds and real edges) and
    the real edges' gather backward (the bonds' feeds only the cut loss,
    which is not trained on).  DimeNet's and DimeNet++'s ``layers`` are
    their blocks (``KJ_SUMS``).  The SE(3)-Transformer (``SE3``, and the
    pooled SE3Transformer) per attention block the softmax denominators' and
    the weighted values' sums at src forward, and the backwards of the
    gathers of the queries and the denominators at src and of the block's
    input at dst (none for the first block's input); then ``conv_out`` as
    TFN's convolutions."""
    if model in (SE3, "pooled SE3Transformer"):
        fwd, bwd = (0, 0, 2 * layers + 1), (0, 0, 3 * layers + 1)
    elif model == "EGHN":
        block, pooling = layers
        fwd, bwd = (0, 0, 2 * block + 2 * pooling + 2), (0, 0, 4 * block + 2 * pooling + 1)
    elif model in TRIPLET_MODELS:
        fwd, bwd = (0, 0, 2 * layers + 1), (0, 0, KJ_SUMS[model] * layers + 2)
    else:
        f, b = PER_LAYER[model]
        skip_f, skip_b = SKIPS.get(model, ((0, 0, 0), (0, 0, 0)))
        fwd = [layers * f[i] - skip_f[i] for i in range(3)]
        bwd = [layers * b[i] - skip_b[i] for i in range(3)]
    return {k: fwd[i] * (train_steps + forwards) + bwd[i] * train_steps
            for i, k in enumerate(KERNELS)}


def reset_launch_counts() -> None:
    from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm

    ek.FWD_LAUNCHES = ek.BWD_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0


def small_batch(model: str, tmp: str):
    """Phase 3's input on the card: the 400-node Water-3D-shaped graph (with
    its triplet table for DimeNet), or, for the baselines, two graphs of a
    120-atom synthetic protein chain with its bonds (the protein CLI's
    with_local_edges batches; on the Water-3D graph the target is ``loc +
    vel``, which Linear predicts exactly, so its gradient is 0)."""
    from fastegnn_tpu_torch.data.protein import ProteinDataset, make_synthetic_protein_npz
    from fastegnn_tpu_torch.data.synthetic_water import build_batch
    from fastegnn_tpu_torch.graph import build_triplets

    if model not in BASELINES:
        g = build_batch(n_nodes=400, degree=20, seed=3, device="cuda")[0]
        if model in TRIPLET_MODELS:
            g.triplets = build_triplets(g)
        return g
    npz = f"{tmp}/small.npz"
    make_synthetic_protein_npz(npz, n_atoms=120, n_frames=30, seed=3)
    return ProteinDataset(npz, "train", device="cuda", delta_frame=5, cutoff_rate=0.5,
                          with_local_edges=True).collate([0, 1])


def small_model_phase(attention: bool, bf16: bool = False, model: str = "FastEGNN",
                      options=None):
    """Phase 3: the model on the card against the model on the CPU: f32
    within 1e-4, or bf16 (FastEGNN's fused layer only) within 2e-2 of each
    output's largest value; every output (coordinates, virtual coordinates,
    features, EGHN's cut loss, GVP's output tuple) and every gradient.  A
    model without gravity or attention drops them; SchNet and EGHN run at
    ``SMALL_DEPTH``.  DimeNet's zero-initialised last linears are drawn
    afresh and scaled so that its largest output is 1: the basis near d = 0
    makes it ~1e7 on this graph, where 1e-4 would be below f32 rounding.
    ``options`` ([options]): constructor arguments no CLI passes, given to
    the model's constructor beside the keyword arguments it takes."""
    import numpy as np
    import torch

    from fastegnn_tpu_torch.models import MODEL_KWARGS, MODEL_REGISTRY
    from fastegnn_tpu_torch.train.loss import masked_mse
    from fastegnn_tpu_torch.train.step import prediction

    with tempfile.TemporaryDirectory() as tmp:
        g = small_batch(model, tmp)
    gen = torch.Generator().manual_seed(3)
    depth = SMALL_DEPTH.get(model, 2)
    if model in SMALL_TFN_FAMILY:
        gpu, cpu = (tfn_family_model(model, device, gen) for device in ("cuda", "cpu"))
    else:
        # the keyword arguments the model takes (as get_model keeps them),
        # and the options no CLI passes
        kw = dict(hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=2,
                  gravity=(0.0, -1.0, 0.0), attention=attention,
                  compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                  num_interactions=2, layer_per_block=2, layer_pooling=2, num_blocks=2)
        kw = {k: v for k, v in kw.items() if k in MODEL_KWARGS[model]} | (options or {})
        gpu = MODEL_REGISTRY[model](2, 2, device="cuda", generator=gen, **kw)
        cpu = MODEL_REGISTRY[model](2, 2, device="cpu", **kw)
    if model in TRIPLET_MODELS:
        with torch.no_grad():
            lins = [b.lin.weight for b in gpu.output_blocks]
            for w in lins:
                w.copy_(torch.randn(w.shape, generator=gen))
            top = float(gpu(g).abs().max())
            for w in lins:
                w.div_(top)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gc = g.to("cpu")
    outs, launches = [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for net, batch in ((gpu, g), (cpu, gc)):
        out = net(batch)
        pred = prediction(out)
        if pred.shape[0] == batch.num_nodes:
            masked_mse(pred, batch.coord_target, batch.node_mask).backward()
        else:   # a pooled model's [B, 1]
            pred.square().sum().backward()
        outs.append(([t.detach().cpu() for t in flat_outputs(out)],
                     {k: p.grad.detach().cpu() for k, p in net.named_parameters()
                      if p.grad is not None}))
        if launches is None:   # the card's run
            torch.cuda.synchronize()
            launches = launch_counts()
    want = ({"edge_block_fwd": 0, "edge_block_bwd": 0, "segment_sum": 3 * 2} if attention
            else expected_launches(model, depth, 1, 0))
    check(launches == want, f"small: launches {launches}, expected {want}")
    (o1, g1), (o0, g0) = outs
    mask = gc.node_mask
    errs = []
    for a, b in zip(o1, o0):
        if b.dim() and b.shape[0] == gc.num_nodes:   # node rows: the real nodes only
            a, b = a[mask], b[mask]
        # f32: absolute; bf16: relative to the largest value, as one bf16
        # rounding on either side moves a coordinate by up to ~4e-3 of it
        scale = float(b.abs().max()) if bf16 else 1.0
        errs.append(float((a - b).abs().max()) / scale)
    check(g1.keys() == g0.keys(), "small: different parameters got gradients")
    # each gradient against its own largest entry, floored at 1e-4 of the
    # model's largest gradient: some gradients here are ~1e-12, pure
    # rounding noise (the layer-0 virtual gates see identical channels)
    top = max(float(v.abs().max()) for v in g0.values())
    rel = {k: float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-4 * top)
           for k in g0}
    worst = max(rel, key=rel.get)
    err_g = rel[worst]
    layer = f"{model}, " + ("attention" if attention else "fused" if model == "FastEGNN"
                            else "f32") + (f", {options}" if options else "")
    tol = 2e-2 if bf16 else 1e-4
    mode = "bf16 (coord, virtual rel)" if bf16 else "f32"
    print(f"[small] card vs CPU, {gc.num_nodes} nodes, depth {depth}, {mode}, {layer} layer: "
          f"coord {errs[0]:.3e} other outputs {[f'{e:.3e}' for e in errs[1:]]} grad (rel, worst "
          f"{worst}) {err_g:.3e} (tol {tol:g}); launches {launches}", flush=True)
    check(np.isfinite(errs + [err_g]).all(), "small: bad output")
    check(max(errs + [err_g]) <= tol, "small: card and CPU disagree")
    return dict(coord=errs[0], other_outputs=errs[1:], grad_rel=err_g, tol=tol)


def tfn_family_model(kind: str, device: str, generator):
    """[small]'s TFN-family models beside the registry's TFN, at depth 2:
    the SE(3)-Transformer kind of OurDynamics (nf = 32), and the pooled TFN
    and SE3Transformer (8 channels, 2 degrees, div 1) called on the batch's
    node features."""
    import torch

    from fastegnn_tpu_torch.models.tfn import SE3Transformer, TFN, OurDynamics

    class OnNodeFeatures(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, g):
            return self.net(g.node_feat, g)

    if kind == SE3:
        return OurDynamics(2, 2, nf=TFN_NF, n_layers=2, model=SE3, device=device,
                           generator=generator)
    if kind == "pooled TFN":
        return OnNodeFeatures(TFN(2, 2, 8, num_degrees=2, device=device, generator=generator))
    return OnNodeFeatures(SE3Transformer(2, 2, 8, num_degrees=2, div=1, device=device,
                                         generator=generator))


def flat_outputs(out) -> list:
    """A model's output tensors, nested tuples flattened (its prediction
    first)."""
    if isinstance(out, tuple):
        return [t for o in out for t in flat_outputs(o)]
    return [] if out is None else [out]


def train_path_phase(g, n_real, tag: str, attention: bool, bf16: bool, per_step: dict):
    """Phases 4 and 5: train steps of the full-width Water-3D configuration
    (``tag`` "main": the fused edge block in bf16; "variant": the attention
    layer in f32), with every launch count set to 0 just before the run and
    checked against ``per_step`` launches per step just after."""
    import torch

    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    model = FastEGNN(2, 2, hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=LAYERS,
                     gravity=(0.0, -1.0, 0.0), attention=attention,
                     compute_dtype=torch.bfloat16 if bf16 else torch.float32, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = torch_adam(model.parameters(), 5e-4, 1e-12)
    step = make_train_step(model, opt, sigma=1.0, weight=0.01, sample=3,
                           per_graph_sampling=True,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    mode = ("attention " if attention else "") + ("bf16" if bf16 else "f32")
    launches, step_ms, rate, _ = timed_steps(step, g, n_real, tag, mode, per_step)
    with torch.no_grad():
        x, vx = model(g)
    check(tuple(x.shape) == (g.num_nodes, 3) and tuple(vx.shape) == (1, 3, CHANNELS)
          and bool(torch.isfinite(x).all()) and bool(torch.isfinite(vx).all()),
          f"{tag} path: bad prediction")
    profile_window(step, g, tag)
    return launches, step_ms, rate


def timed_steps(step, g, n_real: int, tag: str, mode: str, per_step: dict):
    """WARMUP + TIMED train steps on the batch ``g``, each timed on the host
    clock up to a synchronize, with every launch count set to 0 just before
    and checked against ``per_step`` launches per step just after.  Returns
    ``(launches, median step ms, M edge-messages/s, peak device GiB)``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics, times = [], []
    for i in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        metrics.append(step(g))
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(time.perf_counter() - t0)
    launches = launch_counts()
    steps = WARMUP + TIMED
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    check(all(v == v and abs(v) < float("inf") for m in losses for v in m.values()),
          f"{tag} path: non-finite loss")
    for name, count in launches.items():
        check(count == per_step[name] * steps,
              f"{tag} path: {name} launched {count} times in {steps} steps, expected "
              f"{per_step[name]} per step")
    step_ms = statistics.median(times) * 1e3
    rate = g.num_edges * LAYERS / (step_ms / 1e3) / 1e6
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {g.num_nodes} nodes, {n_real} real / {g.num_edges} padded edges, "
          f"H={HIDDEN} C={CHANNELS} L={LAYERS} {mode}: median step {step_ms:.3f} ms over "
          f"{TIMED} steps (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{rate:.3f} M edge-messages/s; launches {launches}", flush=True)
    print(f"[{tag}] loss first {losses[0]} last {losses[-1]}; peak device memory "
          f"{peak_gib:.3f} GiB", flush=True)
    return launches, step_ms, rate, peak_gib


def device_rows(prof):
    """``(kernel, device us, count)`` of a profile, longest first: device-side
    events only; a user annotation (Optimizer.step) spans kernels that are
    listed on their own, so it is left out."""
    import torch

    rows = [(ev.key, ev.device_time_total, ev.count) for ev in prof.key_averages()
            if ev.device_time_total > 0 and not getattr(ev, "is_user_annotation", False)
            and ev.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def profile_window(step, g, tag: str, n_steps: int = 3):
    """Device time by kernel over a few steps (torch.profiler); returns
    ``(device kernel ms per step, busy share)``, or None when the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step(g)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    if not rows:
        print(f"[profile] {tag}: no device time in the trace: not measured", flush=True)
        return None
    busy = sum(r[1] for r in rows)
    print(f"[profile] {tag}, {n_steps} steps: wall {wall_us / 1e3:.3f} ms, device kernel time "
          f"{busy / 1e3:.3f} ms (busy share {busy / wall_us:.3f}, profiler on)", flush=True)
    # the 12 longest, and the port's own kernels wherever they rank
    for i, (key, t, cnt) in enumerate(rows):
        if i < 12 or any(k in key for k in OWN_KERNELS):
            print(f"[profile]   {t / n_steps / 1e3:9.4f} ms/step  x{cnt // n_steps:<4d} "
                  f"{key[:90]}", flush=True)
    return busy / n_steps / 1e3, busy / wall_us


def collate_phase(tag: str, dataset, batch_size: int) -> dict:
    """[collate]: the first shuffled batch of ``dataset`` collated on the
    host from the dataset's edge tables (its main path) and by the plain
    collate (``graph.batch_graphs_plain``, batch-wide argsorts), each
    COLLATE_RUNS times; the two batches must be equal in every field.  The
    build of the dataset's edge tables is timed once, beside them."""
    import dataclasses

    import numpy as np
    import torch

    from fastegnn_tpu_torch.graph import batch_graphs_plain, edge_table

    t0 = time.perf_counter()
    for g in dataset.graphs:
        edge_table(g, dataset.spec)
    table_s = time.perf_counter() - t0
    idx = dataset.batch_indices(batch_size, np.random.default_rng(0))[0]
    graphs, spec = [dataset.graphs[i] for i in idx], dataset.batch_spec(len(idx))
    new_s, plain_s = [], []
    for _ in range(COLLATE_RUNS):
        t0 = time.perf_counter()
        got = dataset.host_collate(idx)
        new_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = batch_graphs_plain(graphs, spec, device="cpu")
        plain_s.append(time.perf_counter() - t0)
    fields = [f.name for f in dataclasses.fields(got)
              if isinstance(getattr(got, f.name), torch.Tensor)]
    differ = [f for f in fields if not isinstance(getattr(want, f), torch.Tensor)
              or getattr(want, f).dtype != getattr(got, f).dtype
              or not torch.equal(getattr(want, f), getattr(got, f))]
    check(not differ and got.n_real_edges == want.n_real_edges
          and {f.name for f in dataclasses.fields(want)
               if isinstance(getattr(want, f.name), torch.Tensor)} == set(fields),
          f"{tag}: the batch from the edge tables differs from the plain collate in {differ}")
    new_ms, plain_ms = (1e3 * statistics.median(v) for v in (new_s, plain_s))
    out = dict(collate_ms=new_ms, plain_collate_ms=plain_ms, table_build_s=table_s,
               graphs=len(dataset), batch=len(idx), real_edges=got.n_real_edges,
               padded_edges=got.num_edges)
    print(f"[collate] {tag}: batch {len(idx)} x {spec.max_nodes} nodes, {got.n_real_edges} real "
          f"/ {got.num_edges} padded edges: from the edge tables {new_ms:.3f} ms, plain "
          f"(batch-wide argsorts) {plain_ms:.3f} ms per batch (median of {COLLATE_RUNS}), "
          f"{plain_ms / new_ms:.1f}x; the {len(dataset)} graphs' edge tables built in "
          f"{table_s:.3f} s; the two batches equal in all {len(fields)} tensor "
          f"fields", flush=True)
    return out


def cli_datasets():
    """The synthetic Water-3D splits of the CLI path, on the card."""
    import numpy as np

    from fastegnn_tpu_torch.data.simulation import SimulationDataset, synthetic_trajectories

    t0 = time.perf_counter()
    trajectories = synthetic_trajectories(CLI_TRAJ, N_NODES, CLI_FRAMES, seed=43)
    t1 = time.perf_counter()
    sets = [SimulationDataset.from_trajectories(trajectories[s], s, device="cuda",
                                                virtual_channels=CHANNELS, cutoff_rate=0.5,
                                                radius=CLI_RADIUS, seed=43)
            for s in ("train", "valid", "test")]
    per_node = [np.array([gr["n_edges"] / gr["n_nodes"] for gr in d.graphs]) for d in sets]
    print(f"[cli] datasets: trajectories {t1 - t0:.2f} s, samples {time.perf_counter() - t1:.2f} "
          f"s; sizes {[len(d) for d in sets]}, nodes {sets[0].spec.max_nodes}, radius "
          f"{CLI_RADIUS}, real edges per node mean / min / max "
          f"{[f'{a.mean():.1f} / {a.min():.1f} / {a.max():.1f}' for a in per_node]}, edges per "
          f"graph (max) {[d.spec.max_edges for d in sets]}", flush=True)
    return sets


def cli_args(tmp: str, *more: str):
    from fastegnn_tpu_torch.cli.simulation import build_parser

    return build_parser().parse_args([
        "--data_directory", tmp, "--virtual_channel", str(CHANNELS), "--cutoff_rate", "0.5",
        "--radius", str(CLI_RADIUS),
        "--seed", "43", "--max_epochs", str(CLI_EPOCHS), "--test_interval", "1",
        "--ckpt_directory", f"{tmp}/ckpt", "--log_directory", f"{tmp}/logs", *more])


def cli_phase(tmp: str):
    """Phase 6: the Water-3D CLI's training run on the card, resumed from its
    best checkpoint for one more epoch under the profiler; then the f32
    edge kernels against their plain versions on one of its batches.
    Returns ``(launches, kernel results, trained model, test dataset,
    collate figures)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastegnn_tpu_torch.cli.common import run_training
    from fastegnn_tpu_torch.train.checkpoint import restore_checkpoint
    from fastegnn_tpu_torch.train.step import make_train_step

    dtr, dva, dte = cli_datasets()
    args = cli_args(tmp)
    check(args.batch_size == 20 and args.dim_hidden == HIDDEN and args.num_layer == LAYERS
          and args.compute_dtype == "float32", "cli: the CLI's defaults changed")
    collate = collate_phase("cli", dtr, args.batch_size)
    n_train = dtr.num_batches(args.batch_size)
    n_eval = dva.num_batches(args.batch_size) + dte.num_batches(args.batch_size)
    padded = -(-dtr.spec.max_edges * args.batch_size // 1024) * 1024
    torch.cuda.synchronize()
    reset_launch_counts()
    run = run_training(args, dtr, dva, dte, per_graph_sampling=True, gravity=(0.0, -1.0, 0.0))
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"edge_block_fwd": LAYERS * CLI_EPOCHS * (n_train + n_eval),
            "edge_block_bwd": LAYERS * CLI_EPOCHS * n_train, "segment_sum": 0}
    log = run.log
    print(f"[cli] {CLI_EPOCHS} epochs of {n_train} train steps and {n_eval} eval batches, "
          f"batch {args.batch_size} x {dtr.spec.max_nodes} nodes, {padded} padded edges, "
          f"f32: launches {launches} (expected {want}); losses train {log['loss_train']} "
          f"test {log['loss']}", flush=True)
    check(launches == want, "cli: launch counts differ from the path's")
    check(all(v == v and abs(v) < float("inf") for v in log["loss_train"] + log["loss"]),
          "cli: non-finite loss")
    check(run.step == CLI_EPOCHS * n_train, f"cli: {run.step} train steps")
    logs = glob.glob(f"{tmp}/logs/*_loss_*.json")
    check(len(logs) == 1, "cli: no JSON log")
    with open(logs[0]) as f:
        best, logged = json.load(f)
    check(logged["loss"] == log["loss"] and best["epoch_index"] >= 1, "cli: bad JSON log")
    for e, tel in enumerate(log["telemetry"]):
        coll = dtr.collate_seconds[e * n_train:(e + 1) * n_train]
        rate = padded * LAYERS / (tel["step_ms_median"] / 1e3) / 1e6
        print(f"[cli] epoch {tel['epoch']}: wall {tel['seconds']:.3f} s, median step "
              f"{tel['step_ms_median']:.3f} ms, {rate:.3f} M edge-messages/s, host collate "
              f"{1e3 * sum(coll) / len(coll):.3f} ms per train batch, peak device memory "
              f"{tel['peak_device_gib']} GiB", flush=True)
    ev = dva.collate_seconds + dte.collate_seconds
    print(f"[cli] eval batches collated once each: {len(ev)}, "
          f"{1e3 * sum(ev) / len(ev):.3f} ms per batch", flush=True)

    # resume: a run that stops at the checkpoint's epoch holds exactly what
    # it restored; one more epoch then trains from there
    ckpt = f"{tmp}/ckpt/best"
    ck = restore_checkpoint(ckpt, map_location="cuda")
    held = run_training(cli_args(tmp, "--resume", ckpt, "--max_epochs", str(ck["epoch"])),
                        dtr, dva, dte, per_graph_sampling=True, gravity=(0.0, -1.0, 0.0))
    sd = held.model.state_dict()
    same_model = sd.keys() == ck["model"].keys() and all(
        torch.equal(sd[k], ck["model"][k]) for k in sd)
    ost, cst = held.optimizer.state_dict()["state"], ck["optimizer"]["state"]
    same_adam = ost.keys() == cst.keys() and all(
        ost[i].keys() == cst[i].keys() and all(torch.equal(ost[i][k], cst[i][k]) for k in ost[i])
        for i in ost)
    check(same_model and same_adam and held.step == ck["step"] and not held.log["epochs"],
          "cli: resume did not restore the checkpoint exactly")
    reset_launch_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        more = run_training(cli_args(tmp, "--resume", ckpt, "--max_epochs", str(ck["epoch"] + 1)),
                            dtr, dva, dte, per_graph_sampling=True, gravity=(0.0, -1.0, 0.0))
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    check(more.log["epochs"] == [ck["epoch"] + 1] and more.step == ck["step"] + n_train
          and all(v == v and abs(v) < float("inf")
                  for v in more.log["loss_train"] + more.log["loss"]),
          "cli: the resumed run did not train one more epoch")
    check(launch_counts() == {"edge_block_fwd": LAYERS * (n_train + n_eval),
                              "edge_block_bwd": LAYERS * n_train, "segment_sum": 0},
          f"cli: resumed epoch launches {launch_counts()}")
    print(f"[cli] resumed from epoch {ck['epoch']} (step {ck['step']}): model and Adam state "
          f"restored tensor for tensor; epoch {ck['epoch'] + 1} losses train "
          f"{more.log['loss_train']} test {more.log['loss']}", flush=True)
    busy_s = sum(r[1] for r in device_rows(prof)) / 1e6
    epoch_s = more.log["telemetry"][0]["seconds"]
    # a new run collates its eval batches again (the cache is per run), so
    # this epoch is a run's first: 2 + 4 collates
    print(f"[profile] cli, the resumed epoch ({n_train} train steps, {n_eval} eval batches, "
          f"all collated in the epoch; profiler on): device kernel time "
          f"{busy_s * 1e3:.3f} ms, epoch wall {epoch_s * 1e3:.3f} ms (busy share "
          f"{busy_s / epoch_s:.3f}), whole run {window_s * 1e3:.3f} ms (busy share "
          f"{busy_s / window_s:.3f})", flush=True)

    step = make_train_step(run.model, run.optimizer, sigma=args.sigma, weight=args.weight,
                           sample=args.sample, per_graph_sampling=True,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    g = dtr.collate(list(range(args.batch_size)))
    print(f"[cli] profiled batch: {g.num_nodes} nodes, {g.n_real_edges} real / {g.num_edges} "
          f"padded edges", flush=True)
    profile_window(step, g, "cli")
    del step
    torch.cuda.empty_cache()
    kern = kernel_phase(g, torch.Generator().manual_seed(4), modes=(False,), tag="cli")
    return launches, kern, run.model, dte, collate


def rollout_phase(model, dataset):
    """Phase 7: a 5-step rollout of the trained model on one test graph;
    then the f32 forward kernel against its plain version on that graph."""
    import torch

    from fastegnn_tpu_torch.train.rollout import make_rollout

    g = dataset.collate([0])
    roll = make_rollout(model, ROLL_STEPS)
    roll(g)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    traj, v = roll(g)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ROLL_STEPS
    launches = launch_counts()
    print(f"[rollout] {ROLL_STEPS} steps on a {g.num_nodes}-node test graph, "
          f"{g.n_real_edges} edges: {ms:.3f} ms per step; launches {launches}", flush=True)
    want = {"edge_block_fwd": LAYERS * ROLL_STEPS, "edge_block_bwd": 0, "segment_sum": 0}
    check(launches == want, f"rollout: launches {launches}, expected {want}")
    check(tuple(traj.shape) == (ROLL_STEPS, g.num_nodes, 3) and bool(torch.isfinite(traj).all())
          and bool(torch.isfinite(v).all()), "rollout: bad trajectory")
    return kernel_phase(g, torch.Generator().manual_seed(5), modes=(False,), tag="rollout")


def training_cli_phase(tag: str, args, sets):
    """Phases 8 and 9: a training CLI's run of ``args.model`` on the card
    (``run_training`` with the CLI's arguments and datasets, the shared MMD
    draw for the Fast* family, the MSE alone for VNEGNN and the baselines),
    with exact launch counts and per-epoch telemetry; then WARMUP + TIMED
    train steps of the trained model on one batch and a profiler window
    over them.  FastEGNN's and VNEGNN's runs then hold the f32 edge kernels
    against their plain versions on that batch (FastRF's batch is the same
    one), the models of ``PATH_FORMS`` the segment-sum kernel in their
    forms."""
    import torch

    from fastegnn_tpu_torch.cli.common import run_training
    from fastegnn_tpu_torch.graph import build_triplets
    from fastegnn_tpu_torch.models import MMD_MODELS
    from fastegnn_tpu_torch.train.step import make_train_step

    dtr, dva, dte = sets
    use_mmd = args.model in MMD_MODELS
    loss = "shared MMD draw" if use_mmd else "MSE alone"
    n_train = dtr.num_batches(args.batch_size)
    n_eval = dva.num_batches(args.batch_size) + dte.num_batches(args.batch_size)
    # the collate times this run adds to each split's list start here
    k0 = [len(d.collate_seconds) for d in sets]
    torch.cuda.synchronize()
    reset_launch_counts()
    run = run_training(args, dtr, dva, dte, per_graph_sampling=False)
    torch.cuda.synchronize()
    launches = launch_counts()
    depth = DEPTH.get(args.model, LAYERS)
    want = expected_launches(args.model, depth, PATH_EPOCHS * n_train, PATH_EPOCHS * n_eval)
    log = run.log
    print(f"[{tag}] {args.model}, {PATH_EPOCHS} epochs of {n_train} train steps and {n_eval} "
          f"eval batches, batch {args.batch_size}, f32, {loss}: launches {launches} "
          f"(expected {want}); losses train {log['loss_train']} test {log['loss']}", flush=True)
    check(launches == want, f"{tag}: launch counts differ from the path's")
    check(all(v == v and abs(v) < float("inf") for v in log["loss_train"] + log["loss"]),
          f"{tag}: non-finite loss")
    check(run.step == PATH_EPOCHS * n_train and log["epochs"] == list(range(1, PATH_EPOCHS + 1)),
          f"{tag}: {run.step} train steps, eval epochs {log['epochs']}")
    collate = []
    for e, tel in enumerate(log["telemetry"]):
        coll = dtr.collate_seconds[k0[0] + e * n_train:k0[0] + (e + 1) * n_train]
        collate += coll
        print(f"[{tag}] epoch {tel['epoch']}: wall {tel['seconds']:.3f} s, median step "
              f"{tel['step_ms_median']:.3f} ms, host collate {1e3 * sum(coll) / len(coll):.3f} "
              f"ms per train batch, peak device memory {tel['peak_device_gib']} GiB", flush=True)
    ev = dva.collate_seconds[k0[1]:] + dte.collate_seconds[k0[2]:]
    print(f"[{tag}] eval batches collated once each: {len(ev)}, "
          f"{1e3 * sum(ev) / len(ev):.3f} ms per batch", flush=True)

    g = dtr.collate(list(range(args.batch_size)))
    trip = {}
    if args.model in TRIPLET_MODELS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.triplets = build_triplets(g)
        torch.cuda.synchronize()
        trip = dict(triplets=g.triplets.num_triplets, triplet_build_s=time.perf_counter() - t0)
        print(f"[{tag}] triplet table of the {g.n_real_edges}-edge batch: T = "
              f"{trip['triplets']} ({trip['triplets'] / g.n_real_edges:.1f} per edge), built in "
              f"{trip['triplet_build_s']:.4f} s", flush=True)
    step = make_train_step(run.model, run.optimizer, sigma=args.sigma, weight=args.weight,
                           sample=args.sample, per_graph_sampling=False, use_mmd=use_mmd,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    per_step = expected_launches(args.model, depth, 1, 0)
    _, step_ms, rate, peak_gib = timed_steps(step, g, g.n_real_edges, tag,
                                             f"{args.model} f32, {loss}", per_step)
    prof = profile_window(step, g, tag)
    del step, run
    torch.cuda.empty_cache()
    kern = {}
    if args.model in ("FastEGNN", "VNEGNN"):
        kern = kernel_phase(g, torch.Generator().manual_seed(6), modes=(False,), tag=tag)
    elif args.model in PATH_FORMS:
        kern = segsum_phase(g, torch.Generator().manual_seed(7), PATH_FORMS[args.model], tag=tag)
    numbers = dict(step_ms=step_ms, M_edge_messages_per_s=rate,
                   device_ms_per_step=prof[0] if prof else None,
                   busy_share=prof[1] if prof else None, peak_device_gib=peak_gib,
                   collate_ms=1e3 * sum(collate) / len(collate), batch=args.batch_size,
                   nodes=g.num_nodes, real_edges=g.n_real_edges, padded_edges=g.num_edges,
                   **trip)
    return launches, kern, numbers


def se3_transformer_phase(tag: str, sets, batch_size: int):
    """The SE(3)-Transformer kind of OurDynamics at the JAX defaults (nf =
    32, L = LAYERS, div 1, one head; no CLI flag selects it) through the
    train step on one N-body CLI batch, on the MSE alone as the CLIs train
    TFN: WARMUP + TIMED train steps with exact launch counts, a profiler
    window, and its segment-sum forms against their plain versions."""
    import torch

    from fastegnn_tpu_torch.models.tfn import OurDynamics
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    g = sets[0].collate(list(range(batch_size)))
    model = OurDynamics(2, 2, nf=TFN_NF, n_layers=LAYERS, model=SE3, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    opt = torch_adam(model.parameters(), 5e-4, 1e-12)
    step = make_train_step(model, opt, sigma=1.5, weight=0.01, sample=3,
                           per_graph_sampling=False, use_mmd=False)
    launches, step_ms, rate, peak_gib = timed_steps(
        step, g, g.n_real_edges, tag, f"{SE3} nf={TFN_NF} f32, MSE alone",
        expected_launches(SE3, LAYERS, 1, 0))
    with torch.no_grad():
        x = model(g)
    check(tuple(x.shape) == (g.num_nodes, 3) and bool(torch.isfinite(x).all()),
          f"{tag}: bad prediction")
    prof = profile_window(step, g, tag)
    del step, model, opt, x
    torch.cuda.empty_cache()
    kern = segsum_phase(g, torch.Generator().manual_seed(8), SE3_FORMS, tag=tag)
    numbers = dict(step_ms=step_ms, M_edge_messages_per_s=rate,
                   device_ms_per_step=prof[0] if prof else None,
                   busy_share=prof[1] if prof else None, peak_device_gib=peak_gib,
                   batch=batch_size, nodes=g.num_nodes, real_edges=g.n_real_edges,
                   padded_edges=g.num_edges)
    return launches, kern, numbers


def each_model(tag: str, parse, sets, models) -> dict:
    """``training_cli_phase`` for each of ``models`` on the same datasets;
    ``parse(more)`` gives the CLI's arguments with ``more`` added."""
    out = {}
    for model in models:
        args = parse(["--model", model])
        out[model] = training_cli_phase(tag if model == "FastEGNN" else f"{tag} {model}",
                                        args, sets)
    return out


def edges_per_node(sets):
    """Mean / min / max real edges per node of each split's graphs."""
    import numpy as np

    per_node = [np.array([gr["n_edges"] / gr["n_nodes"] for gr in d.graphs]) for d in sets]
    return [f"{a.mean():.1f} / {a.min():.1f} / {a.max():.1f}" for a in per_node]


def nbody_model(spec, device: str):
    """FastEGNN as the N-body CLI builds it (H=64, C=3, L=4, f32, seed 43)."""
    import torch

    from fastegnn_tpu_torch.models import get_model

    return get_model("FastEGNN", spec.node_feat_dim, spec.edge_attr_dim, hidden=HIDDEN,
                     virtual_channels=CHANNELS, n_layers=LAYERS, num_blocks=LAYERS,
                     compute_dtype=torch.float32, device=device,
                     generator=torch.Generator().manual_seed(43))


def flat_params(model):
    return {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}


def grads_of(model):
    import torch

    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().clone()
            for k, p in model.named_parameters()}


def masked_diff(a: dict, b: dict, grads):
    """Max |a - b| where every gradient in ``grads`` is >= 1e-6 (a None
    gradient counts as 0), and over all entries, and the count of the
    entries left out."""
    import torch

    masked, full, left = 0.0, 0.0, 0
    for k in a:
        keep = torch.stack([gr[k].abs() >= 1e-6 for gr in grads]).all(0)
        d = (a[k] - b[k]).abs()
        masked = max(masked, float(d[keep].max()) if bool(keep.any()) else 0.0)
        full, left = max(full, float(d.max())), left + int((~keep).sum())
    return masked, full, left


def dp_rank(rank: int, store: str, graphs, spec, state: dict, out: str) -> None:
    """[dp] (a): one of DP_RANKS gloo ranks on cuda:0, spawned by
    ``dp_phase``: ``DP_STEPS`` data-parallel train steps (N-body CLI
    configuration, weight 0) on its half of the first N-body batch, drawn by
    ``iter_dp_batches`` from the whole batch; then ``all_reduce`` calls of
    the flat gradient's size, timed, and ``make_dp_agree``'s broadcast of
    rank 0's eval losses (the loop's early-stop decision).  Writes its parameters, metrics,
    launches and times to ``out`` followed by its rank."""
    import torch
    import torch.distributed as dist

    from fastegnn_tpu_torch.data.batcher import GraphDataset
    from fastegnn_tpu_torch.parallel import (
        iter_dp_batches,
        make_dp_agree,
        make_dp_train_step,
        make_mesh,
    )
    from fastegnn_tpu_torch.train.loop import step_key
    from fastegnn_tpu_torch.train.optim import torch_adam

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo takes CUDA tensors; NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=DP_RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((DP_RANKS,), ("data",), "cuda")
        ds = GraphDataset(graphs, spec, device="cuda")
        g = next(iter(iter_dp_batches(ds, len(graphs), mesh)))
        model = nbody_model(spec, "cuda")
        model.load_state_dict(state)
        step = make_dp_train_step(model, torch_adam(model.parameters(), 5e-4, 1e-12), mesh,
                                  sigma=1.5, weight=0.0)
        torch.cuda.synchronize()
        reset_launch_counts()
        metrics, times = [], []
        for i in range(DP_STEPS):
            t0 = time.perf_counter()
            metrics.append({k: float(v) for k, v in step(g, step_key(43, 0, 1, i)).items()})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = launch_counts()
        buf = torch.ones(sum(p.numel() for p in model.parameters()), device="cuda")
        ar = []
        for _ in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            ar.append(time.perf_counter() - t0)
        check(bool((buf == DP_RANKS ** (WARMUP + TIMED)).all()), "dp: gloo's CUDA all_reduce")
        agreed = make_dp_agree(mesh)(1.0 + rank, 0.5)
        check(agreed == [1.0, 0.5], f"dp: rank {rank} agreed on {agreed}, not rank 0's losses")
        torch.save(dict(params=flat_params(model), metrics=metrics, launches=launches,
                        step_ms=[t * 1e3 for t in times], nodes=g.num_nodes,
                        real_edges=g.n_real_edges, n_graphs=g.n_graphs,
                        allreduce_ms=statistics.median(ar[WARMUP:]) * 1e3), f"{out}{rank}")
    finally:
        dist.destroy_process_group()


def dp_phase(tmp: str, dtr, batch_size: int) -> tuple:
    """The data-parallel path on the one card, at the N-body CLI's
    configuration on the first batch of its train split (100 graphs,
    10,000 nodes, 495,000 real edges): (a) ``DP_RANKS`` gloo ranks on
    cuda:0, each on its contiguous half, after ``DP_STEPS`` steps held
    against as many one-process steps on the whole batch (the MSE to 1e-5,
    each parameter to ``DP_ATOL`` where neither one-process step's gradient
    is below 1e-6: there the atomics' last bits can flip Adam's first
    update, ~lr * sign(g)), the ranks' parameters bitwise equal, 4 + 4 f32
    edge-kernel launches per rank step; (b) a one-rank NCCL group: the
    data-parallel step with the MMD term on against the plain step on the
    same key (the first step's metrics bitwise, parameters as in (a)), and
    both steps timed."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fastegnn_tpu_torch.parallel import initialize_distributed, make_dp_train_step, make_mesh
    from fastegnn_tpu_torch.train.loop import step_key
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    graphs, spec = dtr.graphs[:batch_size], dtr.spec
    g = dtr.collate(list(range(len(graphs))))
    init = nbody_model(spec, "cpu").state_dict()

    def fresh():
        m = nbody_model(spec, "cuda")
        m.load_state_dict(init)
        return m, torch_adam(m.parameters(), 5e-4, 1e-12)

    # the one-process reference: DP_STEPS steps on the whole batch
    model, opt = fresh()
    step = make_train_step(model, opt, sigma=1.5, weight=0.0)
    ref, grads = [], []
    for i in range(DP_STEPS):
        ref.append({k: float(v) for k, v in step(g, step_key(43, 0, 1, i)).items()})
        grads.append(grads_of(model))
    ref_params = flat_params(model)
    n_values = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    del model, opt, step
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    ctx = mp.start_processes(dp_rank, args=(f"{tmp}/dp_store", graphs, spec, init,
                                            f"{tmp}/dp_rank"),
                             nprocs=DP_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_JOIN_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"dp: the ranks did not end in {DP_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/dp_rank{r}", weights_only=False) for r in range(DP_RANKS)]
    per_step = {"edge_block_fwd": LAYERS, "edge_block_bwd": LAYERS, "segment_sum": 0}
    for r, out in enumerate(ranks):
        check(out["n_graphs"] == len(graphs) // DP_RANKS, f"dp: rank {r}'s sub-batch")
        check(out["launches"] == {k: v * DP_STEPS for k, v in per_step.items()},
              f"dp: rank {r} launched {out['launches']} in {DP_STEPS} steps")
        for i in range(DP_STEPS):
            check(abs(out["metrics"][i]["mse"] - ref[i]["mse"]) <= 1e-5 * abs(ref[i]["mse"]),
                  f"dp: rank {r} step {i} mse {out['metrics'][i]['mse']} against {ref[i]['mse']}")
    for k, v in ranks[0]["params"].items():
        check(all(torch.equal(v, out["params"][k]) for out in ranks[1:]),
              f"dp: the ranks' {k} differ")
    a_diff, a_all, a_left = masked_diff(ranks[0]["params"], ref_params, grads)
    print(f"[dp] (a) {DP_RANKS} gloo ranks on cuda:0 in {ranks_s:.2f} s (spawn included): "
          f"{ranks[0]['nodes']} nodes, {ranks[0]['real_edges']} real edges per rank; "
          f"{DP_STEPS} steps, mse {[m['mse'] for m in ranks[0]['metrics']]} against one process "
          f"{[m['mse'] for m in ref]}; parameters against one process: max |diff| "
          f"{a_diff:.3e} where |g| >= 1e-6 (tol {DP_ATOL}), {a_all:.3e} over all, "
          f"{a_left} of {n_values} values left out; ranks bitwise equal; launches per rank "
          f"{ranks[0]['launches']}; step ms {ranks[0]['step_ms']}; gloo all_reduce of "
          f"{n_values} f32 ({n_tensors} tensors) on CUDA: median "
          f"{ranks[0]['allreduce_ms']:.3f} ms", flush=True)
    check(a_diff <= DP_ATOL, f"dp: parameters differ from one process by {a_diff:.3e}")

    # (b) a one-rank NCCL group: the DP step at D = 1 is the plain step
    initialize_distributed("cuda", init_method=f"file://{tmp}/nccl_store", world_size=1,
                           rank=0, timeout_s=300)
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        kw = dict(sigma=1.5, weight=0.01)
        m_dp, o_dp = fresh()
        m_pl, o_pl = fresh()
        dp_step = make_dp_train_step(m_dp, o_dp, mesh, **kw)
        plain = make_train_step(m_pl, o_pl, **kw)
        key = step_key(43, 0, 1, 0)
        first_dp, first_pl = dp_step(g, key), plain(g, key)
        b_grads = [grads_of(m_pl)]
        firsts = [{k: float(v) for k, v in m.items()} for m in (first_dp, first_pl)]
        check(firsts[0] == firsts[1] and firsts[0]["mmd"] != 0.0,
              f"dp: one NCCL rank's first step {firsts[0]} against the plain step's {firsts[1]}")
        b_diff, b_all, b_left = masked_diff(flat_params(m_dp), flat_params(m_pl), b_grads)
        check(b_diff <= DP_ATOL, f"dp: one NCCL rank's parameters differ by {b_diff:.3e}")
        reset_launch_counts()
        ms = {}
        for name, fn in (("plain", plain), ("dp", dp_step), ("dp again", dp_step),
                         ("plain again", plain)):
            times = []
            for i in range(WARMUP + TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(g, step_key(43, 0, 2, i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms[name] = statistics.median(times[WARMUP:]) * 1e3
        launches = launch_counts()
        n_steps = 4 * (WARMUP + TIMED)
        check(launches == {k: v * n_steps for k, v in per_step.items()},
              f"dp: (b) launched {launches} in {n_steps} steps")
    finally:
        dist.destroy_process_group()
    print(f"[dp] (b) one NCCL rank, MMD on (sigma 1.5, weight 0.01): first step {firsts[0]} "
          f"equal to the plain step's; parameters max |diff| {b_diff:.3e} where |g| >= 1e-6, "
          f"{b_all:.3e} over all ({b_left} left out); median step ms over {TIMED} after "
          f"{WARMUP} warm-up, in turns plain / dp / dp / plain: {ms}; launches {launches}",
          flush=True)
    numbers = dict(nodes=ranks[0]["nodes"], real_edges_per_rank=ranks[0]["real_edges"],
                   global_real_edges=g.n_real_edges, ranks_s=ranks_s,
                   gloo_rank_step_ms=ranks[0]["step_ms"],
                   gloo_allreduce_ms=ranks[0]["allreduce_ms"], grad_values=n_values,
                   grad_tensors=n_tensors, params_max_abs_diff=a_diff,
                   params_max_abs_diff_all=a_all, nccl1_params_max_abs_diff=b_diff,
                   nccl1_step_ms=ms, nccl1_launches=launches)
    return ranks[0]["launches"], {}, numbers


def gp_model(bf16: bool, state):
    """The main path's FastEGNN (H=64, C=3, L=4, gravity) on the card, in
    f32 or bf16, with the weights ``state`` (None: drawn from seed 0)."""
    import torch

    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN

    model = FastEGNN(2, 2, hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=LAYERS,
                     gravity=(0.0, -1.0, 0.0),
                     compute_dtype=torch.bfloat16 if bf16 else torch.float32, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    return model


def gp_rank(rank: int, store: str, host, state: dict, draws, out: str) -> None:
    """[gp] (a): one of GP_RANKS gloo ranks on cuda:0, spawned by
    ``gp_phase``: its shard of the main path's graph, the f32 and bf16
    owner-sharded forwards, ``GP_STEPS`` train steps on ``draws`` (launches
    counted), then ``TIMED`` more steps and the halo ``all_to_all`` alone,
    timed.  Writes its results to ``out`` followed by its rank."""
    import torch
    import torch.distributed as dist

    from fastegnn_tpu_torch.parallel import (
        make_mesh,
        make_owner_gp_forward,
        make_owner_gp_train_step,
        make_owner_sharded_batch,
    )
    from fastegnn_tpu_torch.train.optim import torch_adam

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=GP_RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((GP_RANKS,), ("graph",), "cuda")
        shard = make_owner_sharded_batch(host, GP_RANKS, shard=rank, device="cuda")
        model = gp_model(False, state)
        x, vloc = make_owner_gp_forward(model, mesh)(shard)
        x16, vloc16 = make_owner_gp_forward(gp_model(True, state), mesh)(shard)
        step = make_owner_gp_train_step(model, torch_adam(model.parameters(), 5e-4, 1e-12),
                                        mesh, **GP_STEP_KW)
        torch.cuda.synchronize()
        reset_launch_counts()
        metrics = [{k: float(v) for k, v in step(shard, draw=d.cuda()).items()} for d in draws]
        torch.cuda.synchronize()
        launches = launch_counts()
        params = flat_params(model)
        times = []
        for i in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            step(shard, draw=draws[i % len(draws)].cuda())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        send = torch.randn(tuple(shard.send_idx.shape) + (HIDDEN + 3,), device="cuda")
        got = torch.empty_like(send)
        a2a = []
        for _ in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            dist.all_to_all_single(got, send, group=mesh.get_group("graph"))
            torch.cuda.synchronize()
            a2a.append(time.perf_counter() - t0)
        torch.save(dict(x=x.cpu(), vloc=vloc.cpu(), x16=x16.cpu(), vloc16=vloc16.cpu(),
                        metrics=metrics, launches=launches, params=params,
                        step_ms=statistics.median(times[WARMUP:]) * 1e3,
                        a2a_ms=statistics.median(a2a[WARMUP:]) * 1e3,
                        owned=shard.n_owned, halo=shard.send_idx.shape[1],
                        table=shard.rowptr.shape[0] - 1, edges=shard.n_real_edges),
                   f"{out}{rank}")
    finally:
        dist.destroy_process_group()


def gp_table_view(host, n_shards: int, shard: int):
    """Shard ``shard``'s edges over its table, as ``kernel_phase`` reads a
    graph: the coordinates of its owned rows, then of the rows each shard
    sends it (on the card)."""
    from types import SimpleNamespace

    import torch

    from fastegnn_tpu_torch.parallel import make_owner_sharded_batch

    shards = [make_owner_sharded_batch(host, n_shards, shard=j, device="cuda")
              for j in range(n_shards)]
    mine = shards[shard]
    coord = torch.cat([mine.coord] + [s.coord[s.send_idx[shard].long()] for s in shards])
    return SimpleNamespace(device=coord.device, num_nodes=coord.shape[0], coord=coord,
                           n_real_edges=mine.n_real_edges, rowptr=mine.rowptr, src=mine.src,
                           dst=mine.dst, edge_attr=mine.edge_attr)


def gp_phase(tmp: str, g) -> dict:
    """The owner-sharded graph-parallel path on the one card, on the main
    path's graph (8000 nodes, 580,032 real edges) at its configuration:
    (a) ``GP_RANKS`` gloo ranks on cuda:0, each on its owned rows and its
    halo table, against one process: the f32 forward (``GP_FWD_TOL`` of the
    largest value), ``GP_STEPS`` f32 train steps on the same MMD draws (the
    MSE to 1e-6 relative, the parameters to ``DP_ATOL`` where |g| >= 1e-6),
    the bf16 forward (``GP_BF16_TOL``), 4 + 4 f32 edge-kernel launches per
    rank step; S, the halo bytes per layer, the ``all_to_all``'s and the
    steps' ms; the f32 edge kernels against their plain versions on rank
    0's table; (b) a one-rank NCCL group: the owner step (G = 1, NCCL's
    ``all_to_all_single``) against the plain step, both timed, then a
    profiler window over each."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fastegnn_tpu_torch.parallel import (
        halo_pair_rows,
        initialize_distributed,
        make_mesh,
        make_owner_gp_train_step,
        make_owner_sharded_batch,
    )
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    host = g.to("cpu")
    gen = torch.Generator().manual_seed(3)
    state = {k: v.cpu() for k, v in gp_model(False, None).state_dict().items()}
    draws = [torch.rand((1, g.num_nodes), generator=gen) for _ in range(GP_STEPS)]
    per_step = {"edge_block_fwd": LAYERS, "edge_block_bwd": LAYERS, "segment_sum": 0}

    # one process: the forwards, GP_STEPS steps on the draws, then timed steps
    with torch.no_grad():
        x_ref, v_ref = gp_model(False, state)(g)
        x16_ref, v16_ref = gp_model(True, state)(g)
    model = gp_model(False, state)
    plain = make_train_step(model, torch_adam(model.parameters(), 5e-4, 1e-12), **GP_STEP_KW)
    ref, grads = [], []
    for d in draws:
        ref.append({k: float(v) for k, v in plain(g, draw=d.cuda()).items()})
        grads.append(grads_of(model))
    ref_params = flat_params(model)
    times = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(g, draw=draws[i % GP_STEPS].cuda())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    one_ms = statistics.median(times[WARMUP:]) * 1e3
    del model, plain
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    ctx = mp.start_processes(gp_rank, args=(f"{tmp}/gp_store", host, state, draws,
                                            f"{tmp}/gp_rank"),
                             nprocs=GP_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + GP_JOIN_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"gp: the ranks did not end in {GP_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/gp_rank{r}", weights_only=False) for r in range(GP_RANKS)]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    want = {k: v.cpu() for k, v in (("x", x_ref), ("vloc", v_ref), ("x16", x16_ref),
                                    ("vloc16", v16_ref))}
    errs = {}
    for r, out in enumerate(ranks):
        for k, tol in (("x", GP_FWD_TOL), ("vloc", GP_FWD_TOL), ("x16", GP_BF16_TOL),
                       ("vloc16", GP_BF16_TOL)):
            errs[k] = max(errs.get(k, 0.0), rel(out[k], want[k]))
            check(errs[k] <= tol, f"gp: rank {r}'s {k} is {errs[k]:.3e} of the largest value "
                                  f"from one process's (tol {tol:g})")
        check(out["launches"] == {k: v * GP_STEPS for k, v in per_step.items()},
              f"gp: rank {r} launched {out['launches']} in {GP_STEPS} steps")
        for i in range(GP_STEPS):
            check(abs(out["metrics"][i]["mse"] - ref[i]["mse"]) <= 1e-6 * abs(ref[i]["mse"]),
                  f"gp: rank {r} step {i} mse {out['metrics'][i]['mse']} against {ref[i]['mse']}")
    for k, v in ranks[0]["params"].items():
        check(all(torch.equal(v, out["params"][k]) for out in ranks[1:]),
              f"gp: the ranks' {k} differ")
    a_diff, a_all, a_left = masked_diff(ranks[0]["params"], ref_params, grads)
    check(a_diff <= DP_ATOL, f"gp: parameters differ from one process by {a_diff:.3e}")
    halo = ranks[0]["halo"]
    halo_bytes = GP_RANKS * halo * (HIDDEN + 3) * 4
    pair_rows = halo_pair_rows(host, GP_RANKS)
    print(f"[gp] (a) {GP_RANKS} gloo ranks on cuda:0 in {ranks_s:.2f} s (spawn included): "
          f"owned rows {[o['owned'] for o in ranks]}, S {halo} (all pairs {pair_rows} real "
          f"rows), tables {[o['table'] for o in ranks]} rows, real edges "
          f"{[o['edges'] for o in ranks]}; halo block [{GP_RANKS}, {halo}, {HIDDEN + 3}] f32 = "
          f"{halo_bytes} B per layer per rank each way; forward against one process: f32 x "
          f"{errs['x']:.3e}, vloc {errs['vloc']:.3e} (tol {GP_FWD_TOL:g}), bf16 x "
          f"{errs['x16']:.3e}, vloc {errs['vloc16']:.3e} (tol {GP_BF16_TOL:g}) of the largest "
          f"value; {GP_STEPS} steps, mse {[m['mse'] for m in ranks[0]['metrics']]} against "
          f"{[m['mse'] for m in ref]}; parameters max |diff| {a_diff:.3e} where |g| >= 1e-6 "
          f"(tol {DP_ATOL}), {a_all:.3e} over all ({a_left} left out); ranks bitwise equal; "
          f"launches per rank {ranks[0]['launches']}; median step ms over {TIMED} after "
          f"{WARMUP}: ranks {[o['step_ms'] for o in ranks]}, one process {one_ms:.3f}; gloo "
          f"all_to_all of the halo block on CUDA: median ms {[o['a2a_ms'] for o in ranks]}",
          flush=True)
    table = kernel_phase(gp_table_view(host, GP_RANKS, 0), torch.Generator().manual_seed(9),
                         modes=(False,), tag="gp table")

    # (b) a one-rank NCCL group: the owner step at G = 1 against the plain step
    initialize_distributed("cuda", init_method=f"file://{tmp}/gp_nccl_store", world_size=1,
                           rank=0, timeout_s=300)
    try:
        mesh = make_mesh((1,), ("graph",), "cuda")
        shard = make_owner_sharded_batch(host, 1, shard=0, device="cuda")
        m_gp, m_pl = gp_model(False, state), gp_model(False, state)
        owner = make_owner_gp_train_step(m_gp, torch_adam(m_gp.parameters(), 5e-4, 1e-12), mesh,
                                         **GP_STEP_KW)
        plain = make_train_step(m_pl, torch_adam(m_pl.parameters(), 5e-4, 1e-12), **GP_STEP_KW)
        d = draws[0].cuda()
        firsts = [{k: float(v) for k, v in fn(b, draw=d).items()}
                  for fn, b in ((owner, shard), (plain, g))]
        check(all(abs(firsts[0][k] - firsts[1][k]) <= 1e-6 * abs(firsts[1][k]) for k in firsts[1]),
              f"gp: one NCCL rank's first step {firsts[0]} against the plain step's {firsts[1]}")
        b_diff, b_all, b_left = masked_diff(flat_params(m_gp), flat_params(m_pl), [grads_of(m_pl)])
        check(b_diff <= DP_ATOL, f"gp: one NCCL rank's parameters differ by {b_diff:.3e}")
        reset_launch_counts()
        ms = {}
        for name, fn, b in (("plain", plain, g), ("owner", owner, shard),
                            ("owner again", owner, shard), ("plain again", plain, g)):
            times = []
            for i in range(WARMUP + TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(b, draw=draws[i % GP_STEPS].cuda())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms[name] = statistics.median(times[WARMUP:]) * 1e3
        launches = launch_counts()
        n_steps = 4 * (WARMUP + TIMED)
        check(launches == {k: v * n_steps for k, v in per_step.items()},
              f"gp: (b) launched {launches} in {n_steps} steps")
        # where the owner step's extra time goes: device kernels or host
        profiled = {name: profile_window(lambda b, fn=fn: fn(b, draw=d), b, f"gp (b) {name}")
                    for name, fn, b in (("plain step", plain, g),
                                        ("owner step, G = 1", owner, shard))}
    finally:
        dist.destroy_process_group()
    print(f"[gp] (b) one NCCL rank (G = 1): first step {firsts[0]} against the plain step's "
          f"{firsts[1]}; parameters max |diff| {b_diff:.3e} where |g| >= 1e-6, {b_all:.3e} over "
          f"all ({b_left} left out); median step ms over {TIMED} after {WARMUP} warm-up, in "
          f"turns plain / owner / owner / plain: {ms}; launches {launches}", flush=True)
    return dict(launches=ranks[0]["launches"], nccl1_launches=launches, table=table,
                numbers=dict(owned=[o["owned"] for o in ranks], halo_rows=halo,
                             halo_pair_rows=pair_rows, tables=[o["table"] for o in ranks],
                             edges=[o["edges"] for o in ranks], halo_bytes=halo_bytes,
                             a2a_ms=[o["a2a_ms"] for o in ranks],
                             rank_step_ms=[o["step_ms"] for o in ranks], one_process_step_ms=one_ms,
                             forward_rel_err=errs, params_max_abs_diff=a_diff,
                             params_max_abs_diff_all=a_all, ranks_s=ranks_s,
                             nccl1_params_max_abs_diff=b_diff, nccl1_step_ms=ms,
                             nccl1_profiled=profiled))


def scaling_phase() -> dict:
    """Phase 6, ``[scaling]``: ``scripts/torch_bench_scaling.py``'s sweep,
    each run of ``SCALING_RUNS`` in its own ``torchrun`` world on the card
    (the kernels built here, loaded by the ranks).  Each line's graph and
    halo fields against the JAX script's (``SCALING_JAX``), its backend,
    card and loss, and L + L f32 edge launches per rank step on every rank
    (no segment-sum); then the f32 edge kernels against their plain
    versions on every rank's table of every run."""
    import contextlib
    import io
    import math

    import torch

    bench = script_module("torch_bench_scaling")
    runs, launches, table = [], {}, {}
    for nodes, layers, G, per_card in SCALING_RUNS:
        argv = ["--devices", str(G), "--nodes-per-shard", str(nodes), "--layers", str(layers),
                "--iters", str(SCALING_ITERS), "--ranks-per-card", str(per_card)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            every, line = bench.sweep(argv, timeout=SCALING_WORLD_S)
        seconds = time.perf_counter() - t0
        edges, halo, rows = SCALING_JAX[(nodes, G)]
        want = bench.halo_fields(G, halo, rows)
        backend = "nccl" if per_card == 1 else "gloo"
        run = f"G{G} {backend} {nodes}x{layers}"
        tag = f"G = {G} {backend}, {nodes} nodes per shard, {layers} layers"
        kind = "harness check: ranks share the card" if per_card > 1 else "one card per rank"
        print(f"[scaling] {tag} ({kind}; {seconds:.2f} s with torchrun): {json.dumps(every)}",
              flush=True)
        print(f"[scaling] {json.dumps(line)}", flush=True)
        per_step = {"edge_block_fwd": layers, "edge_block_bwd": layers, "segment_sum": 0}
        check((every["metric"], line["metric"]) == ("gp_launches_per_rank_step",
                                                    "gp_weak_scaling"),
              f"scaling: {tag} printed {every} and {line}")
        check({k: line[k] for k in want} == want,
              f"scaling: {tag}'s halo fields {line} against the JAX script's {want}")
        check((line["devices"], line["nodes"], line["edges"], line["backend"],
               line["ranks_per_card"], line["device"]) == (G, nodes * G, edges, backend, per_card,
                                                          torch.cuda.get_device_name(0)),
              f"scaling: {tag}'s line {line}")
        check(math.isfinite(line["mse"]) and line["step_ms"] > 0, f"scaling: {tag}'s line {line}")
        check(every["devices"] == G and every["steps"] == SCALING_ITERS
              and every["ranks"] == [per_step] * G,
              f"scaling: {tag} launched {every['ranks']} per rank step, not {per_step} on each")
        runs.append(dict(line, seconds=seconds))
        launches[run] = every["ranks"]
        host, _ = bench.build_batch(nodes * G)
        for r in range(G):
            table[f"{run} rank {r}"] = kernel_phase(
                gp_table_view(host, G, r), torch.Generator().manual_seed(10), modes=(False,),
                tag=f"scaling table {run} rank {r}")
    return dict(runs=runs, launches=launches, table=table)


def options_phase(dtr, batch_size: int) -> tuple:
    """[options]: the constructor options no CLI sets (``OPTION_RUNS``) at
    H=64, C=3, L=4.  For each, the model on the card against the model on
    the CPU on [small]'s batch (``small_model_phase``), then
    ``OPTION_STEPS`` train steps on the first batch of the N-body train
    split (the N-body CLI's loss: the shared-draw MMD for the Fast* family,
    the MSE alone for VNEGNN; the charges are its node attribute), each
    timed up to a synchronize, with exact launch counts and finite losses;
    then the f32 edge kernels and FastSchNet's segment-sum forms against
    their plain versions on that batch.  Returns ``(launches over the
    runs, kernel checks, numbers)``."""
    import torch

    from fastegnn_tpu_torch.models import MMD_MODELS, MODEL_REGISTRY
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    g = dtr.collate(list(range(batch_size)))
    check(g.node_attr is not None and g.node_attr.shape == (g.num_nodes, 1),
          "options: the N-body batch has no charges")
    numbers, total = {}, dict.fromkeys(KERNELS, 0)
    for tag, model, dtype, options in OPTION_RUNS:
        bf16 = dtype == "bfloat16"
        small = small_model_phase(attention=False, bf16=bf16, model=model, options=options)
        kw = dict(hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=LAYERS, **options)
        if bf16:
            kw["compute_dtype"] = torch.bfloat16
        net = MODEL_REGISTRY[model](2, 2, device="cuda",
                                    generator=torch.Generator().manual_seed(43), **kw)
        opt = torch_adam(net.parameters(), 5e-4, 1e-12)
        step = make_train_step(net, opt, sigma=1.5, weight=0.01, sample=3,
                               per_graph_sampling=False, use_mmd=model in MMD_MODELS,
                               generator=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, times = [], []
        for _ in range(OPTION_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(g)["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        want = expected_launches(model, LAYERS, OPTION_STEPS, 0)
        print(f"[options] {tag} {options}: {OPTION_STEPS} train steps on {g.num_nodes} nodes, "
              f"{g.n_real_edges} edges: step ms {[f'{t:.3f}' for t in times]}, losses "
              f"{losses}; launches {launches} (expected {want})", flush=True)
        check(launches == want, f"options {tag}: launch counts differ from the path's")
        check(all(v == v and abs(v) < float("inf") for v in losses),
              f"options {tag}: non-finite loss")
        for k in KERNELS:
            total[k] += launches[k]
        numbers[tag] = dict(options=options, dtype=dtype, launches=launches, step_ms=times,
                            losses=losses, small=small)
        del step, opt, net
        torch.cuda.empty_cache()
    kern = kernel_phase(g, torch.Generator().manual_seed(9), modes=(False,), tag="options")
    kern["FastSchNet forms"] = segsum_phase(g, torch.Generator().manual_seed(10),
                                            SCHNET_FORMS, tag="options")
    return total, kern, numbers


def nbody_phase(tmp: str):
    """Phase 8: the N-body CLI (``run_nbody.sh``'s configuration) on
    trajectories written by the port's generator with a worker per CPU,
    once, then trained on by each model.  Returns ``(runs, [collate]
    figures)``."""
    import torch

    from fastegnn_tpu_torch.cli import nbody
    from fastegnn_tpu_torch.data.nbody_sim import generate_dataset

    t0 = time.perf_counter()
    name = generate_dataset(f"{tmp}/nbody", NB_PARTICLES, num_train=NB_TRAJ,
                            num_valid=NB_TRAJ, num_test=NB_TRAJ, length=NB_LENGTH,
                            n_workers=os.cpu_count())
    gen_s = time.perf_counter() - t0
    print(f"[nbody] generated {name}: 3 x {NB_TRAJ} trajectories of {NB_PARTICLES} particles "
          f"and {NB_LENGTH} steps in {gen_s:.2f} s, {os.cpu_count()} workers "
          f"(os.cpu_count())", flush=True)

    def parse(more):
        return nbody.build_parser().parse_args([
            "--data_directory", f"{tmp}/nbody", "--dataset_name", name,
            "--virtual_channel", str(CHANNELS), "--cutoff_rate", "0.5", "--seed", "43",
            "--max_epochs", str(PATH_EPOCHS), "--test_interval", "1",
            "--log_directory", f"{tmp}/nbody_logs", *more])

    args = parse([])
    check((args.model, args.batch_size, args.sigma, args.weight, args.dim_hidden,
           args.num_layer, args.compute_dtype)
          == ("FastEGNN", 100, 1.5, 0.01, HIDDEN, LAYERS, "float32"),
          "nbody: the CLI's defaults changed")
    t0 = time.perf_counter()
    sets = nbody.datasets(args, torch.device("cuda"))
    check([len(d) for d in sets] == [NB_TRAJ] * 3, "nbody: split sizes")
    print(f"[nbody] datasets in {time.perf_counter() - t0:.2f} s: sizes {[len(d) for d in sets]}, "
          f"nodes {sets[0].spec.max_nodes}, edges per graph {sets[0].spec.max_edges}, real "
          f"edges per node {edges_per_node(sets)}", flush=True)
    collate = collate_phase("nbody", sets[0], args.batch_size)
    t0 = time.perf_counter()
    dp = dp_phase(tmp, sets[0], args.batch_size)
    print(f"[dp] phase took {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    options = options_phase(sets[0], args.batch_size)
    print(f"[options] phase took {time.perf_counter() - t0:.2f} s", flush=True)
    runs = each_model("nbody", parse, sets,
                      ("FastEGNN",) + NEW_MODELS + NBODY_BASELINES + ZOO + ("TFN",))
    runs["FastEGNN"][2].update(generate_s=gen_s, cpus=os.cpu_count())
    runs["dp"] = dp
    runs["options"] = options
    runs[SE3] = se3_transformer_phase(f"nbody {SE3}", sets, args.batch_size)
    return runs, collate


def protein_phase(tmp: str):
    """Phase 9: the protein CLI (``run_protein.sh``'s configuration) on a
    synthetic chain of AdK's backbone size, trained on by each model; EGHN
    on the CLI's datasets with the bond edges.  Returns ``(runs, [collate]
    figures)``."""
    import torch

    from fastegnn_tpu_torch.cli import protein
    from fastegnn_tpu_torch.data.protein import make_synthetic_protein_npz

    t0 = time.perf_counter()
    npz = f"{tmp}/adk.npz"
    make_synthetic_protein_npz(npz, n_atoms=PROT_ATOMS, n_frames=PROT_FRAMES, seed=0)

    def parse(more):
        return protein.build_parser().parse_args([
            "--npz", npz, "--virtual_channel", str(CHANNELS), "--cutoff_rate", "0.5",
            "--seed", "43", "--max_epochs", str(PATH_EPOCHS), "--test_interval", "1",
            "--log_directory", f"{tmp}/protein_logs", *more])

    args = parse([])
    check((args.model, args.batch_size, args.sigma, args.weight, args.delta_frame,
           args.dim_hidden, args.num_layer, args.compute_dtype)
          == ("FastEGNN", 50, 1.0, 0.5, 15, HIDDEN, LAYERS, "float32"),
          "protein: the CLI's defaults changed")
    sets = protein.datasets(args, torch.device("cuda"))
    check([len(d) for d in sets] == PROT_SIZES, f"protein: split sizes {[len(d) for d in sets]}")
    print(f"[protein] npz and datasets in {time.perf_counter() - t0:.2f} s: {PROT_ATOMS} atoms, "
          f"{PROT_FRAMES} frames, sizes {[len(d) for d in sets]}, edges per graph (max) "
          f"{[d.spec.max_edges for d in sets]}, real edges per node {edges_per_node(sets)}",
          flush=True)
    collate = {"FastEGNN": collate_phase("protein", sets[0], args.batch_size)}
    fib = sets[0].collate([0, 1]).virtual_fibonacci
    check(fib is not None and tuple(fib.shape) == (2, 3, CHANNELS)
          and fib.device.type == "cuda",
          "protein: no virtual_fibonacci on the batch")
    runs = each_model("protein", parse, sets, ("FastEGNN",) + NEW_MODELS + ("EGNN", "TFN"))
    t0 = time.perf_counter()
    bond_args = parse(["--model", "EGHN"])
    bond_sets = protein.datasets(bond_args, torch.device("cuda"))
    check([len(d) for d in bond_sets] == PROT_SIZES
          and all(d.spec.max_local_edges == PROT_ATOMS - 1 for d in bond_sets),
          "protein: EGHN's datasets have no bonds")
    print(f"[protein] EGHN's datasets with the bond edges in {time.perf_counter() - t0:.2f} s: "
          f"{bond_sets[0].spec.max_local_edges} bonds per graph", flush=True)
    collate["EGHN"] = collate_phase("protein EGHN", bond_sets[0], bond_args.batch_size)
    runs["EGHN"] = training_cli_phase("protein EGHN", bond_args, bond_sets)
    return runs, collate


def equivariance_phase():
    """Phase 10: the equivariance CLI on the card for each model, at the
    reference's 10 nodes and at 100; each trial runs two forwards."""
    import torch

    from fastegnn_tpu_torch.cli import equivariance

    errors = {}
    for model in ("FastEGNN",) + NEW_MODELS + EQUIVARIANT_BASELINES + ("TFN",):
        for argv in ([], ["--nodes", "100"]):
            argv = [*argv, "--model", model]
            args = equivariance.build_parser().parse_args(argv)
            torch.cuda.synchronize()
            reset_launch_counts()
            rc = equivariance.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts()
            errs = equivariance.errors(args)   # the same seed: main's trials again
            print(f"[equivariance] {model}, {args.nodes} nodes, "
                  f"{args.nodes * (args.nodes - 1)} edges: rc {rc}, errors {errs}; launches "
                  f"{launches}", flush=True)
            want = expected_launches(model, DEPTH.get(model, LAYERS), 0, 2 * args.trials)
            check(rc == 0 and len(errs) == args.trials == 3 and max(errs) <= args.atol == 1e-4,
                  f"equivariance: {model} at {args.nodes} nodes failed (rc {rc}, errors {errs})")
            check(launches == want, f"equivariance: {model} launches {launches}, expected {want}")
            errors[f"{model} {args.nodes}"] = errs
    return errors


def script_module(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parity_phase(tmp: str):
    """Phase 12: the converged-parity harness on the card, ``PARITY_EPOCHS``
    epochs of each of ``PARITY_MODELS`` on a 5-particle set of
    ``PARITY_SIZES`` trajectories, with exact launches; then the f32 edge
    kernels and ``PARITY_EGNN_FORMS`` against their plain versions on the
    first batch of its train split; then :func:`parity_water3d_phase` and
    :func:`parity_protein_phase`.  Returns ``(per model, and for the
    Water-3D and protein runs, its launches and numbers, the edge kernels'
    checks, the segment-sum's, the edge kernels' checks on the Water-3D
    batch and on the protein batch)``."""
    import torch

    harness = script_module("torch_parity_nbody")
    hp = harness.HP
    draw = harness.ensure_dataset(f"{tmp}/parity", "5_0_0", os.cpu_count(), length=NB_LENGTH,
                                  **PARITY_SIZES)
    print(f"[parity] generated 5_0_0: {PARITY_SIZES} trajectories of 5 particles and "
          f"{NB_LENGTH} steps in {draw['generate_s']:.2f} s, {draw['n_workers']} workers",
          flush=True)
    n_train = PARITY_SIZES["num_train"] // hp["batch_size"]
    evals = PARITY_EPOCHS // hp["test_interval"]
    n_eval = evals * (PARITY_SIZES["num_valid"] + PARITY_SIZES["num_test"]) // hp["batch_size"]
    out = {}
    for model in PARITY_MODELS:
        path = f"{tmp}/parity_{model}.json"
        torch.cuda.synchronize()
        reset_launch_counts()
        best, log = harness.run_port(PARITY_EPOCHS, path, data=f"{tmp}/parity", name="5_0_0",
                                     model=model)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = expected_launches(model, LAYERS, PARITY_EPOCHS * n_train, n_eval)
        with open(path) as f:
            written = json.load(f)
        print(f"[parity] {model}, {PARITY_EPOCHS} epochs of {n_train} train steps, {evals} "
              f"evals of {n_eval // evals} batches: {best['seconds_per_epoch']:.4f} s per epoch, "
              f"median step {best['step_ms_median']:.3f} ms; train losses {log['loss_train']}, "
              f"test {log['loss']}; launches {launches} (expected {want})", flush=True)
        harness_run_checks(model, best, log, written, PARITY_EPOCHS, hp["test_interval"])
        check(launches == want, f"parity: {model} launch counts differ from the path's")
        out[model] = dict(launches=launches, seconds_per_epoch=best["seconds_per_epoch"],
                          step_ms_median=best["step_ms_median"], loss_test=best["loss_test"],
                          generate_s=draw["generate_s"])
    dtr = harness.load_datasets(f"{tmp}/parity", "5_0_0", "FastEGNN", torch.device("cuda"))[0]
    g = dtr.collate(list(range(hp["batch_size"])))
    empty = int((g.rowptr[1:] == g.rowptr[:-1]).sum())
    print(f"[parity] batch of {hp['batch_size']} graphs: {g.num_nodes} nodes, "
          f"{g.n_real_edges} real edges ({g.n_real_edges / g.num_nodes:.2f} per node), "
          f"{empty} nodes with no edge in", flush=True)
    kern = kernel_phase(g, torch.Generator().manual_seed(8), modes=(False,), tag="parity")
    seg = segsum_phase(g, torch.Generator().manual_seed(9), PARITY_EGNN_FORMS, tag="parity")
    out[PARITY_WATER3D], w_kern = parity_water3d_phase(tmp)
    out[PARITY_PROTEIN], p_kern = parity_protein_phase(tmp)
    return out, kern, seg, w_kern, p_kern


def parity_water3d_phase(tmp: str):
    """Phase 12b: the Water-3D matched harness
    (``scripts/torch_parity_simulation.py::run_port``: FastEGNN with gravity,
    per-graph MMD, f32) for ``PARITY_WATER3D_EPOCHS`` epochs on the
    committed protocol, with exact launches; then the f32 edge kernels
    against their plain versions on the first batch of its train split (10
    graphs of 200 particles, most rows without an edge).  Returns (its
    launches and numbers, the edge kernels' checks)."""
    import torch

    harness = script_module("torch_parity_simulation")
    hp = harness.HP
    with open(harness.PROTOCOL_PATH) as f:
        sizes = {s: len(p["order"]) for s, p in json.load(f).items()}
    n_train = sizes["train"] // hp["batch_size"]
    evals = PARITY_WATER3D_EPOCHS // hp["test_interval"]
    n_eval = evals * (sizes["valid"] // hp["batch_size"] + sizes["test"] // hp["batch_size"])
    path = f"{tmp}/parity_water3d.json"
    torch.cuda.synchronize()
    reset_launch_counts()
    best, log = harness.run_port(PARITY_WATER3D_EPOCHS, path)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = expected_launches("FastEGNN", LAYERS, PARITY_WATER3D_EPOCHS * n_train, n_eval)
    with open(path) as f:
        written = json.load(f)
    print(f"[parity] Water-3D, {PARITY_WATER3D_EPOCHS} epochs of {n_train} train steps, "
          f"{evals} evals of {n_eval // evals} batches: {best['seconds_per_epoch']:.4f} s per "
          f"epoch, median step {best['step_ms_median']:.3f} ms; train losses "
          f"{log['loss_train']}, test {log['loss']}; launches {launches} (expected {want})",
          flush=True)
    harness_run_checks("Water-3D", best, log, written, PARITY_WATER3D_EPOCHS,
                       hp["test_interval"])
    check(launches == want, "parity: Water-3D launch counts differ from the path's")
    dtr = harness.load_datasets(torch.device("cuda"))[0][0]
    g = dtr.collate(list(range(hp["batch_size"])))
    empty = int((g.rowptr[1:] == g.rowptr[:-1]).sum())
    print(f"[parity] Water-3D batch of {hp['batch_size']} graphs: {g.num_nodes} nodes, "
          f"{g.n_real_edges} real edges ({g.n_real_edges / g.num_nodes:.2f} per node), "
          f"{empty} nodes with no edge in", flush=True)
    kern = kernel_phase(g, torch.Generator().manual_seed(10), modes=(False,),
                        tag="parity_water3d")
    return dict(launches=launches, seconds_per_epoch=best["seconds_per_epoch"],
                step_ms_median=best["step_ms_median"], loss_test=best["loss_test"],
                rows=g.num_nodes, real_edges=g.n_real_edges, empty_rows=empty), kern


def harness_run_checks(tag: str, best: dict, log: dict, written, epochs: int,
                       interval: int) -> None:
    """The checks of a harness run: the reference's ``[best, log]`` written,
    every epoch logged and an eval every ``interval``, finite losses, a
    falling train loss."""
    check(written == [best, log] and {"epoch_index", "loss_valid", "loss_test",
                                      "loss_train"} <= best.keys()
          and sorted(log) == ["epochs", "loss", "loss_train"],
          f"parity: {tag}'s JSON is not the reference's [best, log]")
    check(len(log["loss_train"]) == epochs and log["epochs"] == list(
        range(interval, epochs + 1, interval)), f"parity: {tag} logged epochs {log['epochs']}")
    losses = log["loss_train"] + log["loss"] + [best["loss_valid"], best["loss_test"]]
    check(all(v == v and abs(v) < float("inf") for v in losses),
          f"parity: {tag} non-finite loss")
    check(log["loss_train"][-1] < log["loss_train"][0],
          f"parity: {tag}'s train loss did not fall")


def parity_protein_phase(tmp: str):
    """Phase 12c: the protein harness (``scripts/torch_parity_protein.py::
    run_port``: FastEGNN without gravity, the shared MMD draw at weight
    0.5, f32) for ``PARITY_PROTEIN_EPOCHS`` epochs on the committed
    synthetic AdK chain, with exact launches; then the f32 edge kernels
    against their plain versions on the first batch of its train split (50
    graphs of 60 atoms, their 10 Angstrom contacts).  Returns (its launches
    and numbers, the edge kernels' checks)."""
    import torch

    harness = script_module("torch_parity_protein")
    hp = harness.HP
    t0 = time.perf_counter()
    sets, _ = harness.load_datasets(torch.device("cuda"))
    build_s = time.perf_counter() - t0
    # the loop drops each split's short last batch
    n_train = len(sets[0]) // hp["batch_size"]
    evals = PARITY_PROTEIN_EPOCHS // hp["test_interval"]
    n_eval = evals * (len(sets[1]) // hp["batch_size"] + len(sets[2]) // hp["batch_size"])
    g = sets[0].collate(list(range(hp["batch_size"])))
    del sets
    path = f"{tmp}/parity_protein.json"
    torch.cuda.synchronize()
    reset_launch_counts()
    best, log = harness.run_port(PARITY_PROTEIN_EPOCHS, path)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = expected_launches("FastEGNN", LAYERS, PARITY_PROTEIN_EPOCHS * n_train, n_eval)
    with open(path) as f:
        written = json.load(f)
    print(f"[parity] protein, {PARITY_PROTEIN_EPOCHS} epochs of {n_train} train steps, "
          f"{evals} evals of {n_eval // evals} batches (splits built in {build_s:.2f} s): "
          f"{best['seconds_per_epoch']:.4f} s per epoch, median step "
          f"{best['step_ms_median']:.3f} ms; train losses {log['loss_train']}, test "
          f"{log['loss']}; launches {launches} (expected {want})", flush=True)
    harness_run_checks("protein", best, log, written, PARITY_PROTEIN_EPOCHS,
                       hp["test_interval"])
    check(launches == want, "parity: protein launch counts differ from the path's")
    empty = int((g.rowptr[1:] == g.rowptr[:-1]).sum())
    print(f"[parity] protein batch of {hp['batch_size']} graphs: {g.num_nodes} nodes, "
          f"{g.n_real_edges} real edges ({g.n_real_edges / g.num_nodes:.2f} per node), "
          f"{empty} nodes with no edge in", flush=True)
    kern = kernel_phase(g, torch.Generator().manual_seed(11), modes=(False,),
                        tag="parity_protein")
    return dict(launches=launches, seconds_per_epoch=best["seconds_per_epoch"],
                step_ms_median=best["step_ms_median"], loss_test=best["loss_test"],
                build_s=build_s, rows=g.num_nodes, real_edges=g.n_real_edges,
                empty_rows=empty), kern


def path_launches(paths, name: str) -> dict:
    """The kernel ``name``'s launches over each N-body and protein CLI run,
    as ``{"nbody_launches": ..., "nbody_FastRF_launches": ..., ...}``."""
    return {f"{p}_{'' if m == 'FastEGNN' else m + '_'}launches": run[0][name]
            for p in ("nbody", "protein") for m, run in paths[p].items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    from fastegnn_tpu_torch.data.synthetic_water import build_batch
    from fastegnn_tpu_torch.ops import _cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = _cuda_build.build()
    seconds = time.perf_counter() - t0
    print(f"[build] {seconds:.2f} s for {sorted(reports) or 'cached'}", flush=True)
    for name, text in reports.items():
        for line in _cuda_build.resource_lines(text):
            print(f"[build] {name}: {line}", flush=True)

    t0 = time.perf_counter()
    g, n_real, stats = build_batch(N_NODES, DEGREE, channels=CHANNELS, seed=0, device="cuda")
    print(f"[graph] built in {time.perf_counter() - t0:.2f} s: {g.num_nodes} nodes, "
          f"{n_real} real edges, {g.num_edges} padded, degree {stats}", flush=True)

    kern = kernel_phase(g, torch.Generator().manual_seed(0))
    seg = segsum_phase(g, torch.Generator().manual_seed(1))
    small_model_phase(attention=False)
    small_model_phase(attention=True)
    small_model_phase(attention=False, bf16=True)
    for model in NEW_MODELS + BASELINES + ZOO + ("TFN",) + SMALL_TFN_FAMILY:
        small_model_phase(attention=False, model=model)
    launches, step_ms, rate = train_path_phase(
        g, n_real, "main", attention=False, bf16=True,
        per_step={"edge_block_fwd": LAYERS, "edge_block_bwd": LAYERS, "segment_sum": 0})
    var_launches, var_step_ms, var_rate = train_path_phase(
        g, n_real, "variant", attention=True, bf16=False,
        per_step={"edge_block_fwd": 0, "edge_block_bwd": 0, "segment_sum": 3 * LAYERS})
    phase_s = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gp = gp_phase(tmp, g)
    phase_s["gp"] = time.perf_counter() - t0
    print(f"[gp] phase took {phase_s['gp']:.2f} s", flush=True)
    t0 = time.perf_counter()
    scaling = scaling_phase()
    phase_s["scaling"] = time.perf_counter() - t0
    print(f"[scaling] phase took {phase_s['scaling']:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_kern, trained, test_set, cli_collate = cli_phase(tmp)
    roll_kern = rollout_phase(trained, test_set)
    del trained, test_set
    paths, collate = {}, {"cli": cli_collate}
    for name, phase in (("nbody", nbody_phase), ("protein", protein_phase)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            paths[name], collate[name] = phase(tmp)
        phase_s[name] = time.perf_counter() - t0
        print(f"[{name}] phase took {phase_s[name]:.2f} s", flush=True)
    t0 = time.perf_counter()
    eq_errors = equivariance_phase()
    phase_s["equivariance"] = time.perf_counter() - t0
    print(f"[equivariance] phase took {phase_s['equivariance']:.2f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        parity, parity_kern, parity_seg, water3d_kern, protein_kern = parity_phase(tmp)
    phase_s["parity"] = time.perf_counter() - t0
    print(f"[parity] phase took {phase_s['parity']:.2f} s", flush=True)
    parity_launches = {k: {m: parity[m]["launches"][k] for m in PARITY_RUNS} for k in KERNELS}

    entries = []
    for kind, line in (("fwd", 467), ("bwd", 503)):
        name = f"edge_block_{kind}"
        main, f32 = kern[(kind, "bf16")], kern[(kind, "f32")]
        entries.append({
            "name": name, "route": "cuda",
            "source": "fastegnn_tpu_torch/csrc/edge_block.cu",
            "replaces": f"fastegnn_tpu/ops/edge_kernel_v5.py:{line}",
            "tpu": f"ops/edge_kernel_v5.py::_{kind}_kernel",
            "launches": launches[name], "mode": "bf16",
            **main, "library_ms": None, "f32": f32, "cli_launches": cli_launches[name],
            "cli_f32": cli_kern[(kind, "f32")], "rollout_f32": roll_kern[(kind, "f32")],
            **{f"{p}_f32": paths[p]["FastEGNN"][1][(kind, "f32")]
               for p in ("nbody", "protein")},
            **{f"{p}_VNEGNN_f32": paths[p]["VNEGNN"][1][(kind, "f32")]
               for p in ("nbody", "protein")},
            "options_f32": paths["nbody"]["options"][1][(kind, "f32")],
            **path_launches(paths, name),
            "gp_launches": gp["launches"][name], "gp_nccl1_launches": gp["nccl1_launches"][name],
            "gp_table_f32": gp["table"][(kind, "f32")],
            "scaling_launches": {run: [r[name] for r in ranks]
                                 for run, ranks in scaling["launches"].items()},
            "scaling_table_f32": {table: res[(kind, "f32")]
                                  for table, res in scaling["table"].items()},
            "parity_launches": parity_launches[name],
            "parity_f32": parity_kern[(kind, "f32")],
            "parity_water3d_f32": water3d_kern[(kind, "f32")],
            "parity_protein_launches": parity[PARITY_PROTEIN]["launches"][name],
            "parity_protein_f32": protein_kern[(kind, "f32")],
        })
    entries.append({
        "name": "segment_sum", "route": "cuda",
        "source": "fastegnn_tpu_torch/csrc/segment_sum.cu",
        "replaces": "fastegnn_tpu/ops/spmm.py:87",
        "tpu": "ops/spmm.py::_segment_sum_kernel",
        "launches": var_launches["segment_sum"], "mode": "dst f32",
        "cli_launches": cli_launches["segment_sum"],
        **path_launches(paths, "segment_sum"),
        "gp_launches": gp["launches"]["segment_sum"],
        "gp_nccl1_launches": gp["nccl1_launches"]["segment_sum"],
        "scaling_launches": {run: [r["segment_sum"] for r in ranks]
                             for run, ranks in scaling["launches"].items()},
        "parity_launches": parity_launches["segment_sum"],
        "parity_EGNN_forms": parity_seg,
        **seg["dst f32"],
        "forms": {k: v for k, v in seg.items() if k != "dst f32"},
        **{f"{p}_{m}_forms": run[1] for p in ("nbody", "protein")
           for m, run in paths[p].items() if m in PATH_FORMS},
        "options_FastSchNet_forms": paths["nbody"]["options"][1]["FastSchNet forms"],
    })
    print(json.dumps({"kernels": entries, "step_ms": step_ms,
                      "M_edge_messages_per_s": rate, "variant_step_ms": var_step_ms,
                      "variant_M_edge_messages_per_s": var_rate, "gp": gp["numbers"],
                      "scaling": scaling["runs"],
                      **{p: {m: run[2] for m, run in paths[p].items()}
                         for p in ("nbody", "protein")},
                      "equivariance_max_abs_err": eq_errors, "collate": collate,
                      "parity": {m: {k: v for k, v in parity[m].items() if k != "launches"}
                                 for m in PARITY_RUNS},
                      "phase_s": phase_s}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
