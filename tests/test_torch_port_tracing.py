"""The port's spans (``utils/profiling.py::span``) and its step timer, on
the CPU with tiny graphs: no call into the profiler while none records;
every span of a traced FastEGNN and FastTFN train step, nested as the
step, the model and the launch wrappers place them; the batcher's spans
on the threads that do the work; the CLI's ``--profile_trace`` file; and
the timer's intervals, with the waits between steps in them."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastegnn_tpu_torch.cli import simulation as pcli
from fastegnn_tpu_torch.data.batcher import GraphDataset
from fastegnn_tpu_torch.data.simulation import make_synthetic_simulation_h5
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models import get_model
from fastegnn_tpu_torch.train import loop
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.step import make_train_step
from fastegnn_tpu_torch.utils import profiling

N_NODES, N_LAYERS = 10, 2
# each span's parent in a train step
PARENT = {
    "train.step": None,
    "step.draw": "train.step", "step.forward": "train.step", "step.loss": "train.step",
    "step.backward": "train.step", "step.optimizer": "train.step",
    "model.embed": "step.forward", "tfn.inputs": "step.forward", "layer.tfn": "step.forward",
    "layer.edges": "step.forward", "layer.virtual": "step.forward",
    "layer.update": "step.forward",
    "tfn.radial": "layer.tfn", "ops.edge_fwd": "layer.edges", "ops.edge_bwd": "step.backward",
}
STEP_PARTS = ("train.step", "step.draw", "step.forward", "step.loss", "step.backward",
              "step.optimizer", "model.embed", "layer.edges", "layer.virtual", "layer.update")
SPANS = {
    "FastEGNN": STEP_PARTS + ("ops.edge_fwd", "ops.edge_bwd"),
    "FastTFN": STEP_PARTS + ("tfn.inputs", "layer.tfn", "tfn.radial", "ops.segsum"),
}
# the segment-sum runs in the TFN convolution, in the edge mean and in the backward
SEGSUM_PARENTS = {"layer.tfn", "layer.edges", "step.backward"}
BATCHER = ("batcher.collate", "batcher.pin", "batcher.wait", "batcher.h2d")


def _raw(rng, n):
    loc = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.choice([-1.0, 1.0], size=(n, 1)).astype(np.float32)
    dst, src = np.nonzero(~np.eye(n, dtype=bool))
    keep = rng.random(dst.size) < 0.7
    dst, src = dst[keep].astype(np.int32), src[keep].astype(np.int32)
    d = np.linalg.norm(loc[dst] - loc[src], axis=1, keepdims=True).astype(np.float32)
    feat = np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True), q], 1)
    return dict(node_feat=feat.astype(np.float32), coord=loc, vel=vel, dst=dst, src=src,
                edge_attr=np.concatenate([d, d], 1), coord_target=loc + vel, node_attr=q)


def _spec(n_graphs):
    return GraphSpec(max_nodes=N_NODES, max_edges=N_NODES * (N_NODES - 1), n_graphs=n_graphs,
                     node_feat_dim=2, edge_attr_dim=2, virtual_channels=3)


def _graphs(count, seed=0):
    rng = np.random.default_rng(seed)
    return [pad_graph(_spec(1), **_raw(rng, N_NODES)) for _ in range(count)]


def _step(name):
    model = get_model(name, 2, 2, device="cpu", generator=torch.Generator().manual_seed(0),
                      hidden=64, virtual_channels=3, n_layers=N_LAYERS)
    step = make_train_step(model, torch_adam(model.parameters(), 5e-4, 1e-12), 1.0, 0.01, 3)
    return step, batch_graphs(_graphs(2), _spec(2), device="cpu")


def _spans(path):
    """``(name, thread, start, end, parent name)`` of a Chrome trace's
    annotations, each with the innermost one enclosing it on its thread."""
    events = json.loads(path.read_text())["traceEvents"]
    raw = sorted(((e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation"),
                 key=lambda s: (s[1], s[2], -s[3]))
    out, stack = [], []
    for name, tid, a, b in raw:
        while stack and (stack[-1][1] != tid or stack[-1][3] <= a):
            stack.pop()
        out.append((name, tid, a, b, stack[-1][0] if stack else None))
        stack.append((name, tid, a, b))
    return out


def test_span_is_the_shared_no_op_and_never_calls_the_profiler_when_none_records(monkeypatch):
    named = []
    real = profiling._profiler.record_function

    def counting(name, *args):
        named.append(name)
        return real(name, *args)

    # torch's Adam opens ranges of its own through the same function
    monkeypatch.setattr(profiling._profiler, "record_function", counting)
    assert profiling.span("train.step") is profiling.NO_SPAN
    step, graph = _step("FastEGNN")
    step(graph, np.array([1, 2], np.uint32))
    ds = GraphDataset(_graphs(4), _spec(1), device="cpu")
    assert len(list(ds.iter_collated([[0, 1], [2, 3], [1, 2]], prefetch=2))) == 3
    assert not set(named) & (set(PARENT) | set(BATCHER) | {"ops.segsum"}), named
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("train.step") is not profiling.NO_SPAN


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_traced_train_step_has_every_span_nested_as_listed(tmp_path, name):
    step, graph = _step(name)
    key = np.array([1, 2], np.uint32)
    step(graph, key)
    with profiling.profile_trace(str(tmp_path)):
        step(graph, key)
    spans = _spans(tmp_path / "trace.json")
    seen = {s[0] for s in spans}
    assert set(SPANS[name]) <= seen, set(SPANS[name]) - seen
    for span, _, _, _, parent in spans:
        if span == "ops.segsum":
            assert parent in SEGSUM_PARENTS, (span, parent)
        elif span in PARENT:
            assert parent == PARENT[span], (span, parent)
    counts = {n: sum(1 for s in spans if s[0] == n) for n in seen}
    assert counts["train.step"] == counts["step.forward"] == counts["model.embed"] == 1
    assert counts["layer.virtual"] == N_LAYERS
    assert len({s[1] for s in spans if s[0] in SPANS[name]}) == 1


def test_prefetching_batches_span_the_collate_on_its_thread_and_the_wait_on_the_consumer(
        tmp_path):
    ds = GraphDataset(_graphs(6), _spec(1), device="cpu")
    lists = [[0, 1], [2, 3], [4, 5], [1, 4]]
    with profiling.profile_trace(str(tmp_path)):
        got = list(ds.iter_collated(lists, prefetch=2))
    assert len(got) == len(lists)
    me = threading.get_native_id()
    spans = _spans(tmp_path / "trace.json")
    collate = [s for s in spans if s[0] == "batcher.collate"]
    assert len(collate) == len(lists) and all(s[1] != me for s in collate)
    for name in ("batcher.wait", "batcher.h2d"):
        on = [s[1] for s in spans if s[0] == name]
        assert len(on) == len(lists) and set(on) == {me}, (name, on)


def test_the_cli_profile_trace_holds_the_train_step(tmp_path):
    make_synthetic_simulation_h5(str(tmp_path / "Water-3D"), n_trajectories=1, n_particles=40,
                                 n_frames=40)
    pcli.main(["--data_directory", str(tmp_path), "--virtual_channel", "3", "--batch_size", "2",
               "--max_epochs", "2", "--test_interval", "2", "--max_train_samples", "4",
               "--max_test_samples", "2", "--radius", "0.15", "--platform", "cpu",
               "--log_directory", str(tmp_path / "logs"),
               "--profile_trace", str(tmp_path / "trace")])
    spans = _spans(tmp_path / "trace" / "trace.json")
    steps = [s for s in spans if s[0] == "train.step"]
    assert steps and all(s[4] is None for s in steps)
    assert {s[0] for s in spans} >= {"step.forward", "layer.edges", "ops.edge_fwd",
                                     "batcher.collate"}


def test_step_timer_counts_the_wait_before_each_step():
    wait_s = 0.03

    def batches():
        for i in range(3):
            time.sleep(wait_s)
            yield i

    timer = profiling.StepTimer()
    loss, n = loop._run_epoch_train(lambda batch, key: {"mse": torch.tensor(1.0)},
                                    batches(), 0, 1, timer)
    ms = timer.step_ms()
    assert n == 3 and loss == 1.0
    assert len(ms) == 3 and min(ms) >= 1e3 * wait_s, ms
    assert timer.step_ms() == []
