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
   the CSR branch and its segment-sum kernel, run and read the same way.

Output: one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
N_NODES, DEGREE, LAYERS, HIDDEN, CHANNELS = 8000, 60, 4, 64, 3
WARMUP, TIMED = 3, 20
KERNEL_RUNS, KERNEL_INNER = 7, 10   # median over runs of back-to-back launches
SEGSUM_F = HIDDEN + 3   # the variant path sums [m_e | trans] and grads of [h | x]
SEGSUM_TOL = 1e-5       # both versions sum in f32, possibly in another order
# the port's kernels, which [profile] lists wherever they rank
OWN_KERNELS = ("edge_fwd_kernel", "edge_bwd", "segment_sum_kernel")
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


def kernel_phase(g, gen):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
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
    for bf16 in (False, True):
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
            print(f"[kernel] edge_block_{kind} {mode}: max_abs_err {abs_err:.3e} "
                  f"max_rel_err {rel_err:.3e} (tol {TOL[(kind, bf16)]:g}) | kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            check(rel_err <= TOL[(kind, bf16)],
                  f"edge_block_{kind} {mode}: kernel and plain disagree ({rel_err:.3e})")
            results[(kind, mode)] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
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
    # device-side events only; a user annotation (Optimizer.step) spans
    # kernels that are listed on their own, so it is left out of the sum
    rows = [(ev.key, ev.device_time_total, ev.count) for ev in prof.key_averages()
            if ev.device_time_total > 0 and not getattr(ev, "is_user_annotation", False)
            and ev.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        print(f"[profile] {tag}: no device time in the trace: not measured", flush=True)
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] {tag}, {n_steps} steps: wall {wall_us / 1e3:.3f} ms, device kernel time "
          f"{busy / 1e3:.3f} ms (busy share {busy / wall_us:.3f}, profiler on)", flush=True)
    # the 12 longest, and the port's own kernels wherever they rank
    for i, (key, t, cnt) in enumerate(rows):
        if i < 12 or any(k in key for k in OWN_KERNELS):
            print(f"[profile]   {t / n_steps / 1e3:9.4f} ms/step  x{cnt // n_steps:<4d} "
                  f"{key[:90]}", flush=True)


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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

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
            **main, "library_ms": None, "f32": f32,
        })
    entries.append({
        "name": "segment_sum", "route": "cuda",
        "source": "fastegnn_tpu_torch/csrc/segment_sum.cu",
        "replaces": "fastegnn_tpu/ops/spmm.py:87",
        "tpu": "ops/spmm.py::_segment_sum_kernel",
        "launches": var_launches["segment_sum"], "mode": "dst f32",
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
