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
   CPU (plain versions), f32 for the fused layer and the attention layer
   (1e-4), bf16 for the fused layer (2e-2);
4. the main path: FastEGNN (H=64, C=3, L=4, gravity, bf16) trained with
   Adam(5e-4, 1e-12) and MMD (sigma 1, weight 0.01, sample 3, per graph) on
   the 8000-node graph, 3 warm-up + 20 timed steps, with the kernels' launch
   counts set to 0 just before and read just after; then a short
   torch.profiler window over 3 more steps;
5. the variant path: the same configuration with ``attention=True`` in f32
   (the CLI's ``--attention_required`` off the TPU), whose edge block takes
   the CSR branch and its segment-sum kernel, run and read the same way;
6. the CLI path: ``cli.common.run_training`` with the Water-3D CLI's
   defaults (f32, so the f32 edge kernels; batch 20; ``--virtual_channel 3
   --cutoff_rate 0.5``, and ``--radius 0.075`` for Water-3D's mean degree),
   3 epochs on the synthetic Water-3D trajectories (3 per split, 8000
   particles, built in memory: a GPU machine need not have h5py), with
   exact launch counts, per-epoch telemetry, and a resume from the best
   checkpoint that restores it tensor for tensor and trains one more epoch
   under the profiler (the epoch's busy share); then a profiler window over
   its train step, and the f32 edge kernels against their plain versions
   on that step's 20-graph batch;
7. the rollout: ``train.rollout.make_rollout`` over 5 steps on one test
   graph of the trained model, 4 forward launches per step; then the f32
   edge kernels against their plain versions on that graph.

Output: one JSON line ``{"kernels": [...]}`` (each edge kernel with its
main-path and CLI-path launches, and its f32 check on the CLI batch and
the rollout graph), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import glob
import json
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
# the port's kernels, which [profile] lists wherever they rank
OWN_KERNELS = ("edge_fwd", "edge_bwd", "segment_sum_kernel")
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


def segsum_phase(g, gen):
    """Phase 2b: the segment-sum kernel against its plain version, in the
    three forms the variant path launches, at its shapes."""
    import torch

    from fastegnn_tpu_torch.ops import spmm

    n, e, f = g.num_nodes, g.n_real_edges, SEGSUM_F
    data = torch.randn(e, f, generator=gen).to(g.device)
    offsets = g.rowptr.long()
    src = g.src[:e].long()
    # library yardsticks, timed only here: the dst form is a segment_reduce
    # over the row pointer, the src form an index_add_ at src in edge order
    def by_dst(d):
        return torch.segment_reduce(d, "sum", offsets=offsets)

    def by_src(d):
        return torch.zeros(n, f, device=d.device).index_add_(0, src, d)

    forms = (("dst f32", data, g.rowptr, None, by_dst),
             ("dst bf16", data.bfloat16(), g.rowptr, None, by_dst),
             ("src f32", data, g.src_rowptr, g.src_perm, by_src))
    results = {}
    for name, d, rowptr, perm, library in forms:
        got = spmm.segment_sum_csr(d, rowptr, perm)
        torch.cuda.synchronize()
        want = spmm.segment_sum_csr_plain(d, rowptr, perm)
        check(got.dtype == torch.float32 and tuple(got.shape) == (n, f)
              and bool(torch.isfinite(got).all()), f"segment_sum {name}: bad output")
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        ms = median_ms(lambda: spmm.segment_sum_csr(d, rowptr, perm))
        plain_ms = median_ms(lambda: spmm.segment_sum_csr_plain(d, rowptr, perm))
        library_ms = median_ms(lambda: library(d))
        b_ms, b_by = segsum_bound(e, n, f, d.element_size(), perm is not None)
        print(f"[kernel] segment_sum {name} [{e}, {f}] -> [{n}, {f}]: max_abs_err {err:.3e} "
              f"(tol {SEGSUM_TOL:g} x {top:.3e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        check(err <= SEGSUM_TOL * top, f"segment_sum {name}: kernel and plain disagree ({err:.3e})")
        results[name] = dict(max_abs_err=err, max_rel_err=err / max(top, 1e-30), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
    return results


def launch_counts():
    from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm

    return {"edge_block_fwd": ek.FWD_LAUNCHES, "edge_block_bwd": ek.BWD_LAUNCHES,
            "segment_sum": spmm.SEGSUM_LAUNCHES}


def reset_launch_counts() -> None:
    from fastegnn_tpu_torch.ops import edge_kernel as ek, spmm

    ek.FWD_LAUNCHES = ek.BWD_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0


def small_model_phase(attention: bool, bf16: bool = False):
    """Phase 3: the model on the card against the model on the CPU: f32
    within 1e-4, or bf16 (the fused layer only) within 2e-2."""
    import numpy as np
    import torch

    from fastegnn_tpu_torch.data.synthetic_water import build_batch
    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
    from fastegnn_tpu_torch.train.loss import masked_mse

    g, _, _ = build_batch(n_nodes=400, degree=20, seed=3, device="cuda")
    gen = torch.Generator().manual_seed(3)
    kw = dict(hidden=HIDDEN, virtual_channels=CHANNELS, n_layers=2, gravity=(0.0, -1.0, 0.0),
              attention=attention, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    gpu = FastEGNN(2, 2, device="cuda", generator=gen, **kw)
    cpu = FastEGNN(2, 2, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gc = g.to("cpu")
    outs, launches = [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for model, batch in ((gpu, g), (cpu, gc)):
        x, vx = model(batch)
        masked_mse(x, batch.coord_target, batch.node_mask).backward()
        outs.append((x.detach().cpu(), vx.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                      if p.grad is not None}))
        if launches is None:   # the card's run
            torch.cuda.synchronize()
            launches = launch_counts()
    want = ({"edge_block_fwd": 0, "edge_block_bwd": 0, "segment_sum": 3 * 2} if attention
            else {"edge_block_fwd": 2, "edge_block_bwd": 2, "segment_sum": 0})
    check(launches == want, f"small: launches {launches}, expected {want}")
    (x1, v1, g1), (x0, v0, g0) = outs
    mask = gc.node_mask
    # f32: absolute; bf16: relative to the largest coordinate, as one bf16
    # rounding on either side moves a coordinate by up to ~4e-3 of it
    scale_x = float(x0[mask].abs().max()) if bf16 else 1.0
    scale_v = float(v0.abs().max()) if bf16 else 1.0
    err_x = float((x1 - x0)[mask].abs().max()) / scale_x
    err_v = float((v1 - v0).abs().max()) / scale_v
    check(g1.keys() == g0.keys(), "small: different parameters got gradients")
    # each gradient against its own largest entry, floored at 1e-4 of the
    # model's largest gradient: some gradients here are ~1e-12, pure
    # rounding noise (the layer-0 virtual gates see identical channels)
    top = max(float(v.abs().max()) for v in g0.values())
    rel = {k: float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-4 * top)
           for k in g0}
    worst = max(rel, key=rel.get)
    err_g = rel[worst]
    layer = "attention" if attention else "fused"
    tol = 2e-2 if bf16 else 1e-4
    mode = "bf16 (coord, virtual rel)" if bf16 else "f32"
    print(f"[small] card vs CPU, 400 nodes, L=2, {mode}, {layer} layer: coord {err_x:.3e} "
          f"virtual {err_v:.3e} grad (rel, worst {worst}) {err_g:.3e} (tol {tol:g}); "
          f"launches {launches}", flush=True)
    check(np.isfinite([err_x, err_v, err_g]).all(), "small: bad output")
    check(max(err_x, err_v, err_g) <= tol, "small: card and CPU disagree")


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
    with torch.no_grad():
        x, vx = model(g)
    check(tuple(x.shape) == (g.num_nodes, 3) and tuple(vx.shape) == (1, 3, CHANNELS)
          and bool(torch.isfinite(x).all()) and bool(torch.isfinite(vx).all()),
          f"{tag} path: bad prediction")
    mode = ("attention " if attention else "") + ("bf16" if bf16 else "f32")
    print(f"[{tag}] {g.num_nodes} nodes, {n_real} real / {g.num_edges} padded edges, "
          f"H={HIDDEN} C={CHANNELS} L={LAYERS} {mode}: median step {step_ms:.3f} ms over "
          f"{TIMED} steps (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{rate:.3f} M edge-messages/s; launches {launches}", flush=True)
    print(f"[{tag}] loss first {losses[0]} last {losses[-1]}; peak device memory "
          f"{peak_gib:.3f} GiB", flush=True)
    profile_window(step, g, tag)
    return launches, step_ms, rate


def device_rows(prof):
    """``(kernel, device us, count)`` of a profile, longest first: device-side
    events only; a user annotation (Optimizer.step) spans kernels that are
    listed on their own, so it is left out."""
    import torch

    rows = [(ev.key, ev.device_time_total, ev.count) for ev in prof.key_averages()
            if ev.device_time_total > 0 and not getattr(ev, "is_user_annotation", False)
            and ev.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def profile_window(step, g, tag: str, n_steps: int = 3) -> None:
    """Device time by kernel over a few steps (torch.profiler)."""
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
        return
    busy = sum(r[1] for r in rows)
    print(f"[profile] {tag}, {n_steps} steps: wall {wall_us / 1e3:.3f} ms, device kernel time "
          f"{busy / 1e3:.3f} ms (busy share {busy / wall_us:.3f}, profiler on)", flush=True)
    # the 12 longest, and the port's own kernels wherever they rank
    for i, (key, t, cnt) in enumerate(rows):
        if i < 12 or any(k in key for k in OWN_KERNELS):
            print(f"[profile]   {t / n_steps / 1e3:9.4f} ms/step  x{cnt // n_steps:<4d} "
                  f"{key[:90]}", flush=True)


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
    Returns ``(launches, kernel results, trained model, test dataset)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastegnn_tpu_torch.cli.common import run_training
    from fastegnn_tpu_torch.train.checkpoint import restore_checkpoint
    from fastegnn_tpu_torch.train.step import make_train_step

    dtr, dva, dte = cli_datasets()
    args = cli_args(tmp)
    check(args.batch_size == 20 and args.dim_hidden == HIDDEN and args.num_layer == LAYERS
          and args.compute_dtype == "float32", "cli: the CLI's defaults changed")
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
    return launches, kern, run.model, dte


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
    launches, step_ms, rate = train_path_phase(
        g, n_real, "main", attention=False, bf16=True,
        per_step={"edge_block_fwd": LAYERS, "edge_block_bwd": LAYERS, "segment_sum": 0})
    var_launches, var_step_ms, var_rate = train_path_phase(
        g, n_real, "variant", attention=True, bf16=False,
        per_step={"edge_block_fwd": 0, "edge_block_bwd": 0, "segment_sum": 3 * LAYERS})
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_kern, trained, test_set = cli_phase(tmp)
    roll_kern = rollout_phase(trained, test_set)

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
        })
    entries.append({
        "name": "segment_sum", "route": "cuda",
        "source": "fastegnn_tpu_torch/csrc/segment_sum.cu",
        "replaces": "fastegnn_tpu/ops/spmm.py:87",
        "tpu": "ops/spmm.py::_segment_sum_kernel",
        "launches": var_launches["segment_sum"], "mode": "dst f32",
        "cli_launches": cli_launches["segment_sum"],
        **seg["dst f32"],
        "forms": {k: v for k, v in seg.items() if k != "dst f32"},
    })
    print(json.dumps({"kernels": entries, "step_ms": step_ms,
                      "M_edge_messages_per_s": rate, "variant_step_ms": var_step_ms,
                      "variant_M_edge_messages_per_s": var_rate}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
