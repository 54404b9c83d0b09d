"""The span attribution of ``benchmark/spans.py`` on a hand-built trace of
two profiled steps, beside ``devtrace`` on the same events (its numbers
pinned); and the sequence-number link in a trace of a real step of the
port on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import devtrace, spans

CALLER, AUTOGRAD, PREFETCH, STREAM = 1, 2, 3, 7


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _step(o: float, seq: int, corr: int) -> list:
    """One profiled step at ``o`` us: the harness's spans, the program's, a
    forward op and its backward node, runtime calls and what they launch."""
    ann = "user_annotation"
    ev = [_x(ann, "bench.next_batch", CALLER, o + 10, 40),
          _x(ann, "batcher.wait", CALLER, o + 15, 30),
          _x(ann, "batcher.collate", PREFETCH, o + 20, 280),
          _x(ann, "bench.step", CALLER, o + 50, 400),
          _x(ann, "train.step", CALLER, o + 52, 396),
          _x(ann, "step.forward", CALLER, o + 60, 140),
          _x(ann, "layer.virtual", CALLER, o + 100, 50),
          _x(ann, "tfn.radial", CALLER, o + 160, 30),
          _x(ann, "step.backward", CALLER, o + 210, 190),
          _x(ann, "step.optimizer", CALLER, o + 400, 40),
          _x(ann, "ops.segsum", AUTOGRAD, o + 376, 10),
          _x("cpu_op", "aten::mm", CALLER, o + 110, 10, **{"Sequence number": seq,
                                                          "Fwd thread id": 0}),
          _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", AUTOGRAD, o + 300,
             40, **{"Sequence number": seq, "Fwd thread id": 1})]
    # (thread, call start, call dur, name, kernel start, kernel dur or None for a copy)
    launches = [(CALLER, 112, 5, "virtual_k", 130, 20),      # in layer.virtual
                (CALLER, 70, 5, "fwd_k", 150, 10),           # in step.forward
                (CALLER, 165, 3, "radial_k", 170, 12),       # in tfn.radial
                (AUTOGRAD, 310, 8, "virtual_bwd_k", 320, 30),  # backward node -> layer.virtual
                (AUTOGRAD, 350, 4, "acc_k", 360, 6),         # no node -> step.backward
                (AUTOGRAD, 380, 2, "segsum_k", 400, 10),     # ops.segsum, in step.backward
                (CALLER, 415, 20, "Memcpy HtoD", 370, None),  # a copy, not a launch
                (CALLER, 420, 5, "adam_k", 430, 8)]          # inside the copy's call
    for k, (tid, t, d, name, kt, kd) in enumerate(launches):
        c = corr + k
        ev.append(_x("cuda_runtime", "cudaLaunchKernel" if kd else "cudaMemcpyAsync", tid,
                     o + t, d, correlation=c))
        ev.append(_x("kernel" if kd else "gpu_memcpy", name, STREAM, o + kt, kd or 5,
                     correlation=c))
    # outside train.step: a sync after it, the prefetch thread's page-locked alloc
    ev.append(_x("cuda_runtime", "cudaStreamSynchronize", CALLER, o + 448.5, 1,
                 correlation=corr + 50))
    ev.append(_x("cuda_runtime", "cudaHostAlloc", PREFETCH, o + 25, 50, correlation=corr + 51))
    return ev


def _events(program=True) -> list:
    ev = [_x("user_annotation", "bench.window", CALLER, 0, 1000)]
    ev += _step(0, 10, 100) + _step(500, 11, 200)
    ev.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": CALLER, "args": {}})
    if not program:
        ev = [e for e in ev if e.get("cat") != "user_annotation"
              or e["name"].startswith("bench.")]
    return ev


def test_devtrace_reads_the_same_events_as_before():
    tr = devtrace.parse(_events())
    assert tr.window_us == 1000 and tr.busy_us == 202 and len(tr.kernels) == 14
    assert tr.gaps == [("bench.next_batch", 192), ("bench.step", 138), ("bench.step", 138),
                       ("bench.step", 130), ("host other", 62), ("bench.step", 25),
                       ("bench.step", 25), ("bench.step", 20), ("bench.step", 20),
                       ("bench.step", 10), ("bench.step", 10), ("bench.step", 10),
                       ("bench.step", 10), ("bench.step", 4), ("bench.step", 4)]
    assert devtrace.breakdown(tr, top=3) == {
        "device_ops": [["virtual_bwd_k", 60e-6], ["virtual_k", 40e-6], ["radial_k", 24e-6]],
        "idle_gaps": [["bench.next_batch", 192e-6], ["bench.step", 138e-6],
                      ["bench.step", 138e-6]]}


# per profiled step: waits 30 us; calls under train.step 5 + 5 + 3 + 8 + 4 + 2
# + 20 (the launch at 420 lies inside the copy's call at 415-435) = 47 us of
# a 396 us step; 7 kernels; layer.virtual 20 + 30 us, tfn.radial 12 us
EXPECTED = {"batch_wait_ms": 0.030, "step_host_ms": 0.349, "step_launch_wait_ms": 0.047,
            "step_launches": 7, "virtual_block_ms": 0.050, "radial_mlp_ms": 0.012}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_quantity_reads_its_hand_computed_value(name):
    got = spans.metrics(spans.attribute(spans.parse(_events())))
    assert got[name] == pytest.approx(EXPECTED[name], abs=1e-9)


def test_a_trace_without_program_spans_gives_nothing():
    at = spans.attribute(spans.parse(_events(program=False)))
    assert set(spans.metrics(at).values()) == {None}
    # its idle time still splits by the harness's spans, per harness step
    assert at.n_steps == 2 and spans.idle_by_span(at)["bench.next_batch"] == pytest.approx(80)


def test_a_backward_kernel_goes_to_its_forward_span_by_sequence_number():
    at = spans.attribute(spans.parse(_events()))
    placed = {}
    for name, _, _, corr in at.trace.kernels:
        i = at.by_corr[corr]
        placed.setdefault(name, set()).add((at.names_above(at.call_span[i])[0], at.call_rule[i]))
    assert placed == {"virtual_k": {("layer.virtual", "own")},
                      "fwd_k": {("step.forward", "own")},
                      "radial_k": {("tfn.radial", "own")},
                      "virtual_bwd_k": {("layer.virtual", "seq")},
                      "acc_k": {("step.backward", "step")},
                      "segsum_k": {("ops.segsum", "own")},
                      "adam_k": {("step.optimizer", "own")}}
    # the autograd thread's span lies under what the stepping thread is in
    k = next(i for i, sp in enumerate(at.trace.spans) if sp.name == "ops.segsum")
    assert at.names_above(k) == ["ops.segsum", "step.backward", "train.step", "bench.step",
                                 "bench.window"]
    assert spans.shares(at)["below_train_step"] == 1.0


def test_idle_time_goes_to_the_span_the_stepping_thread_was_in():
    at = spans.attribute(spans.parse(_events()))
    idle = spans.idle_by_span(at)
    assert sum(idle.values()) == pytest.approx(1000 - 202)
    # the waits are idle whole; layer.virtual until its kernel starts (100-130)
    assert idle["batcher.wait"] == pytest.approx(60)
    assert idle["layer.virtual"] == pytest.approx(60)
    # between the steps: 0-10, 450-510 and 950-1000 (bench.window covers it all)
    assert idle["bench.window"] == pytest.approx(120) and spans.NO_SPAN not in idle
    assert "[trace] idle by span" in spans.idle_line(at)


def test_the_installed_torch_links_a_layer_norm_backward_to_the_radial_mlp(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
    from fastegnn_tpu_torch.models import get_model
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(0)
    n = 8
    spec1 = GraphSpec(max_nodes=n, max_edges=n * (n - 1), n_graphs=1, node_feat_dim=2,
                      edge_attr_dim=2, virtual_channels=3)
    graphs = []
    for _ in range(2):
        loc, vel = rng.normal(size=(2, n, 3)).astype(np.float32)
        dst, src = (a.astype(np.int32) for a in np.nonzero(~np.eye(n, dtype=bool)))
        d = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
        graphs.append(pad_graph(spec1, node_feat=np.ones((n, 2), np.float32), coord=loc,
                                vel=vel, dst=dst, src=src, edge_attr=np.concatenate([d, d], 1),
                                coord_target=loc + vel))
    spec = GraphSpec(max_nodes=n, max_edges=n * (n - 1), n_graphs=2, node_feat_dim=2,
                     edge_attr_dim=2, virtual_channels=3)
    graph = batch_graphs(graphs, spec, device="cpu")
    model = get_model("FastTFN", 2, 2, device="cpu", generator=torch.Generator().manual_seed(0),
                      hidden=16, virtual_channels=3, n_layers=1)
    step = make_train_step(model, torch_adam(model.parameters(), 5e-4, 1e-12), 1.0, 0.5, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(graph, np.array([3, 4], np.uint32))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    at = spans.attribute(spans.parse(events))
    ln = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "NativeLayerNormBackward0"]
    assert ln
    assert {at.host_event(e["tid"], float(e["ts"])) for e in ln} == {"tfn.radial"}


@pytest.mark.parametrize("cell", ["fasttfn-protein-train", "water3d-train-resident"])
def test_span_run_splits_a_tiny_run_of_each_cell(tiny_dir, cell):
    from benchmark import span_run

    r = span_run.traced(cell, 2**31 + 11, 0.3, device="cpu", root=tiny_dir, base=tiny_dir)
    assert r["correct"] and list(r)[-2:] == ["spans", "checks"]
    sp = r["spans"]
    m = sp["metrics"]
    # on the CPU no runtime call runs: the step is the host's own work
    assert m["step_launch_wait_ms"] == 0 and m["step_host_ms"] == sp["train_step_ms"]
    assert m["batch_wait_ms"] is not None and sp["program_spans"] > 0
    assert (m["radial_mlp_ms"] is None) == (cell == "water3d-train-resident")
    assert 0 < sp["train_step_ms"] <= sp["bench_step_ms"] <= sp["traced_step_ms"]
    assert sp["idle_line"].startswith("[trace] idle by span")


def test_runtime_time_splits_by_call_and_span():
    at = spans.attribute(spans.parse(_events()))
    got = spans.runtime_us_by_call(at)
    assert got[:2] == [("cudaMemcpyAsync", "step.optimizer", 20.0),
                       ("cudaLaunchKernel", "layer.virtual", 13.0)]
    # each call's own time, the launch inside the copy's call too; the calls
    # outside train.step (a sync after it, the prefetch thread's) are not in it
    assert sum(us for _, _, us in got) == pytest.approx(52)
