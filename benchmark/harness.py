"""One run of one cell: set-up, the checked steps, the measured window, the
optional profiled window, and the comparison with the plain reference.

The program under test is ``fastegnn_tpu_torch``: its dataset and
streaming (``data/``), its model (``models.get_model``), its Adam
(``train.optim.torch_adam``) and the training loop's step
(``train.step.make_train_step``), called as the loop's body calls it,
``step(batch, train.loop.step_key(seed, 0, epoch, i))``.  The benchmark
makes the raw inputs and the initial weights from the seed and hands the
same to the program and to the reference.

Set-up builds one step object and drives it through the first
``warmup_steps`` steps of the cell's own feed; the first three are the
checked ones: their losses, the program's first forward (a hook on the
model), the first gradient as Adam holds it after step 1, and the
parameters after step 3 are kept.  The same object then runs the window.
After the window (and the profiled window) the program's state is freed
and the reference runs the same three steps from the same weights on
graphs it rebuilds from the raw frames.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Callable, Optional

import numpy as np

from benchmark import inputs, manifest
from benchmark.reference import common as ref_common
from benchmark.feed import Feed
from benchmark.weights import load_into, make_weights

CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "fastegnn_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``fastegnn_tpu_torch`` is not ``fastegnn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def build_program(cfg: dict, spec, device):
    """``(model, optimizer, step)`` of the port for a configuration."""
    import torch

    from fastegnn_tpu_torch.models import get_model
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    model = get_model(cfg["model"], spec.node_feat_dim, spec.edge_attr_dim, device=device,
                      hidden=cfg["hidden"], virtual_channels=cfg["virtual_channels"],
                      n_layers=cfg["n_layers"], gravity=cfg.get("gravity"),
                      compute_dtype=getattr(torch, cfg["dtype"]))
    optimizer = torch_adam(model.parameters(), cfg["learning_rate"], cfg["weight_decay"])
    step = make_train_step(model, optimizer, cfg["sigma"], cfg["weight"], cfg["sample"],
                           cfg["per_graph_sampling"])
    return model, optimizer, step


class Checked:
    """What the program gives in the checked steps."""

    def __init__(self):
        self.mse, self.mmd, self.steps, self.batches = [], [], [], []
        self.coord = self.virtual = self.grad1 = self.after3 = None


def _checked_steps(model, optimizer, step, feed, graphs_meta) -> Checked:
    import torch

    out = Checked()
    seen = {}

    def hook(_module, _inputs, result):
        seen["x"] = result[0].detach().cpu().numpy()
        seen["vx"] = result[1].detach().cpu().numpy()

    handle = model.register_forward_hook(hook)
    b1 = optimizer.param_groups[0]["betas"][0]
    names = {p: n for n, p in model.named_parameters()}
    for t in range(CHECKED_STEPS):
        k, batch, key = next(feed)
        indices = feed.order[k]
        out.batches.append(ref_common.host_batch(batch))
        res = step(batch, key)
        out.mse.append(float(res["mse"]))
        out.mmd.append(float(res["mmd"]))
        out.steps.append((list(int(i) for i in indices), key))
        if t == 0:
            handle.remove()
            n_real = [graphs_meta[i] for i in indices]
            out.coord, out.virtual = ref_common.program_outputs(
                seen["x"], seen["vx"], len(indices), n_real)
            # a leaf the loss does not reach has no gradient and no state
            out.grad1 = {names[p]: (optimizer.state[p]["exp_avg"] / (1 - b1)).detach().clone()
                         if "exp_avg" in optimizer.state[p] else torch.zeros_like(p)
                         for p in names}
    out.after3 = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


class Setup:
    """A cell's program, built and driven through its checked steps;
    ``data``: the ``(dataset, raw pool)`` of ``inputs.build``, where already
    built."""

    def __init__(self, cell, seed: int, dev, t_start: float, data=None):
        cfg = cell.config
        self.ds, self.raw = data if data is not None else inputs.build(cfg, seed, dev)
        spec = self.ds.spec
        self.n_max = spec.max_nodes
        self.graphs_meta = [int(g["n_nodes"]) for g in self.ds.graphs]
        edges = [int(g["n_edges"]) for g in self.ds.graphs]
        say(f"[setup] {cell.name}: {len(self.ds)} graphs, nodes per graph {spec.max_nodes}, "
            f"real edges per graph mean {np.mean(edges):.1f} min {min(edges)} max "
            f"{max(edges)}, data {time.perf_counter() - t_start:.2f} s since start")
        self.model, self.optimizer, self.step = build_program(cfg, spec, dev)
        self.weights = make_weights({n: p.shape for n, p in self.model.named_parameters()},
                                    cfg["init"], seed, dev)
        load_into(self.model, self.weights)
        self.feed = Feed(self.ds, cfg, cell.traffic, seed)
        self.checked = _checked_steps(self.model, self.optimizer, self.step, self.feed,
                                      self.graphs_meta)

    def free(self, on_card: bool) -> None:
        """Stop the feed and drop the program's state."""
        import torch

        self.feed.close()
        self.model = self.optimizer = self.step = self.feed = self.ds = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()


def start(workload: str, device: str, root=manifest.ROOT, base=manifest.HERE):
    """``(cell, device, on card)``, with TF32 off as the configurations state."""
    import torch

    cell = manifest.Cell(workload, manifest.load_manifest(root), base)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cell, dev, dev.type == "cuda"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, root=manifest.ROOT,
             base=manifest.HERE) -> dict:
    """Run one cell; returns the result line's dict plus ``checks`` (each
    compared number with its limit), in the order they are printed.
    ``root`` holds ``BENCHMARK.json`` and ``base`` the configurations and
    traffic mixes (a test passes its own)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell, dev, on_card = start(workload, device, root, base)
    cfg, traffic = cell.config, cell.traffic
    sync: Callable[[], None] = torch.cuda.synchronize if on_card else (lambda: None)
    su = Setup(cell, seed, dev, t_start)
    step, feed, ds, graphs_meta = su.step, su.feed, su.ds, su.graphs_meta
    for _ in range(traffic["warmup_steps"] - CHECKED_STEPS):
        _, batch, key = next(feed)
        step(batch, key)
    sync()
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # the measured window
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    events, dispatch, waits, losses, shapes = [], [], [], [], []
    collate_mark = len(ds.collate_seconds)
    while time.perf_counter() - t0 < seconds:
        tw = time.perf_counter()
        k, batch, key = next(feed)
        td = time.perf_counter()
        waits.append(td - tw)
        res = step(batch, key)
        dispatch.append(time.perf_counter() - td)
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        losses.append(res["loss"])
        idx = feed.order[k]
        shapes.append((len(idx), sum(graphs_meta[i] for i in idx),
                       int(batch.n_real_edges), batch.num_nodes))
    sync()
    window_s = time.perf_counter() - t0
    collates = list(ds.collate_seconds[collate_mark:])
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        marks = [start_ev] + events
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        intervals = [d * 1e3 for d in dispatch]
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    n_steps = len(losses)
    window = {"seconds": window_s, "steps": n_steps, "graphs": sum(s[0] for s in shapes),
              "dispatch_s": dispatch, "collate_s": collates, "shapes": shapes,
              "intervals_ms": intervals}
    say(f"[window] {n_steps} steps, {window['graphs']} graphs in {window_s:.4f} s; "
        f"{len(intervals)} step intervals, median {statistics.median(intervals):.3f} ms; host "
        f"ms per step: waiting for the batch {1e3 * statistics.mean(waits):.2f}, in step() "
        f"{1e3 * statistics.mean(dispatch):.2f}; collates {len(collates)}, mean "
        f"{1e3 * statistics.mean(collates) if collates else 0.0:.2f} ms")

    tr = None
    if trace:
        tr = _profiled_window(step, feed, traffic["trace_steps"], graphs_meta, sync)
    del step, feed, ds, batch, res
    su.free(on_card)

    numbers = reference_check(cfg, su.raw, su.weights, su.checked, su.n_max, dev)
    limits = cfg["limits"]
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    failed = int((~finite).sum())
    correct = bool(failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()))

    result = {"correct": correct, "attempted": n_steps, "failed": failed}
    if trace:
        result["metrics"] = _per_layer(cell, cfg, window, tr)
    else:
        result["metrics"] = _end_to_end(cell, window, setup_s, window_peak, on_card)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if tr is not None:
        device_info["busy_s"] = tr["trace"].busy_us / 1e6
        device_info["window_s"] = tr["trace"].window_us / 1e6
    result["device"] = device_info
    if tr is not None:
        from benchmark.devtrace import breakdown

        result["breakdown"] = breakdown(tr["trace"])
    result["checks"] = checks
    return result


def _profiled_window(step, feed, n_steps, graphs_meta, sync) -> dict:
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from benchmark.devtrace import export_and_parse

    sync()
    shapes = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(n_steps):
                with record_function("bench.next_batch"):
                    k, batch, key = next(feed)
                with record_function("bench.step"):
                    step(batch, key)
                idx = feed.order[k]
                shapes.append((len(idx), sum(graphs_meta[i] for i in idx),
                               int(batch.n_real_edges), batch.num_nodes))
            sync()
    tr = export_and_parse(prof)
    say(f"[trace] {n_steps} steps, window {tr.window_us / 1e3:.3f} ms, device busy "
        f"{tr.busy_us / 1e3:.3f} ms, {len(tr.kernels)} kernels")
    return {"trace": tr, "steps": n_steps, "shapes": shapes}


def _end_to_end(cell, window, setup_s, window_peak, on_card: bool) -> dict:
    values = {
        "train_graphs_per_s": window["graphs"] / window["seconds"],
        "step_ms_p90": float(np.percentile(window["intervals_ms"], 90)),
        "peak_device_gib": window_peak / 2**30,
        "setup_s": setup_s,
    }
    say(f"[window] step_ms_p90 over {len(window['intervals_ms'])} step intervals")
    out = {}
    for m in cell.end_to_end:
        v = values[m["name"]]
        if on_card and not (math.isfinite(v) and v > 0):
            raise RuntimeError(f"end-to-end metric {m['name']} reads {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _per_layer(cell, cfg, window, tr) -> dict:
    ctx = {"cfg": cfg, "cell": cell, "window": window, "trace": tr,
           "counter": manifest.counter(cell.entry["config"])}
    out = {}
    for m in cell.per_layer:
        v = manifest.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def reference_check(cfg, raw, weights, checked: Checked, n_max: int, dev,
                    tf32: bool = False) -> dict:
    """The compared numbers: the reference's three steps on graphs it
    rebuilds from the raw frames, against the program's."""
    forward = manifest.reference(cfg["name"]).forward
    t0 = time.perf_counter()
    needed = sorted({i for idx, _ in checked.steps for i in idx})
    graphs = {i: ref_common.rebuild_graph(raw.graphs[i], cfg["radius"], cfg["cutoff_rate"], dev)
              for i in needed}
    parts = {}
    for hb, (idx, _) in zip(checked.batches, checked.steps):
        for k, v in ref_common.batch_mismatch(hb, [graphs[i] for i in idx],
                                              cfg["cutoff_rate"]).items():
            parts[k] = parts.get(k, 0) + v
    mismatch = sum(parts.values())
    if mismatch:
        say(f"[check] batch mismatch by part: {parts}")
    ref = ref_common.train_three(forward, weights, graphs, checked.steps, cfg, n_max)
    if tf32:
        # the control: the reference with TF32 on, in the program's place
        prog = ref_common.train_three(forward, weights, graphs, checked.steps, cfg, n_max,
                                      tf32=True)
    else:
        prog = ref_common.Readings(
            mse=checked.mse, mmd=checked.mmd, coord=checked.coord, virtual=checked.virtual,
            grad1=checked.grad1, change3={k: checked.after3[k] - weights[k] for k in weights})
    numbers = ref_common.compare(prog, ref)
    numbers["batch_mismatch"] = mismatch
    say(f"[check] loss gaps of steps 1-3 {ref_common.loss_gaps(prog, ref)}; worst leaves "
        f"{ref_common.worst_leaves(prog, ref)}")
    say(f"[check] reference {time.perf_counter() - t0:.2f} s; MSE {'control' if tf32 else 'program'}"
        f" {prog.mse} reference {ref.mse}; MMD {prog.mmd} reference {ref.mmd}")
    return numbers
