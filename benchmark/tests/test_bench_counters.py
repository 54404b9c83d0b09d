"""The yardstick's arithmetic against hand counts at tiny shapes: the
kernels' least times, the configurations' model FLOPs, and the per-layer
readers on a made-up trace."""

from __future__ import annotations

import pytest

from benchmark import manifest, roofline
from benchmark.devtrace import Trace, parse


def test_edge_bound_by_hand():
    # n = 2 rows, e = 3 edges, fe = 2, H = 64, f32: the inputs are the two
    # [n, H] tables (1024 B), x (24), rowptr (12), src (12), attributes
    # (24) and the packed weights 136 H f32 (34816): 35912 B
    fwd = (35912 + 2 * 64 * 4 + 2 * 12) / 3.35e12      # bytes bind: 3 x 16640 ops is less
    assert roofline.edge_bound_s("fwd", False, 2, 3, 2) == pytest.approx(fwd, rel=1e-12)
    bwd = (35912 + 12 + 512 + 24 + 1024 + 48 + 34816) / 3.35e12
    assert roofline.edge_bound_s("bwd", False, 2, 3, 2) == pytest.approx(bwd, rel=1e-12)
    # a large e binds by operations: 2 x 2 H^2 + 2 H fe per edge, forward
    e = 10**9
    assert roofline.edge_bound_s("fwd", False, 2, e, 2) == pytest.approx(
        e * (16384 + 256) / 67e12, rel=1e-12)


def test_segsum_bound_by_hand():
    # 10 rows of 3 f32 through a permutation into 4 rows: 120 + 20 + 48 + 40 B
    assert roofline.segsum_bound_s(10, 4, 3, 4, True) == pytest.approx(228 / 3.35e12)
    assert roofline.segsum_bound_s(10, 4, 3, 4, False) == pytest.approx(188 / 3.35e12)


def test_fastegnn_flops_by_hand():
    cfg = {"hidden": 2, "virtual_channels": 1, "n_layers": 1, "gravity": [0, -1, 0],
           "edge_kernels": {"fe": 2, "bf16": False}}
    # one graph, 3 nodes, 4 edges, H = 2, C = 1: per layer the edge block
    # 48 + 128, the virtual block 24 + 12 + 108, the velocity and gravity
    # heads 72, phi_h 96, phi_hv 24 (512); the embedding 24
    count = manifest.counter("fastegnn-water3d")
    assert count.forward_flops(cfg, 1, 3, 4) == 536
    assert count.step_flops(cfg, 1, 3, 4) == 3 * 536


def test_fasttfn_flops_by_hand():
    cfg = {"hidden": 2, "virtual_channels": 1, "n_layers": 2}
    # per layer and edge the radial MLPs 2176 + 2304 and the contractions
    # 66 (4 edges: 18184), the virtual block 144; in the first layer only,
    # phi_e and the feature MLPs 248; the embedding 24
    count = manifest.counter("fasttfn-protein")
    assert count.forward_flops(cfg, 1, 3, 4) == 24 + 2 * (18184 + 144) + 248
    assert count.step_flops(cfg, 1, 3, 4) == 3 * 36928


def _trace(kernels, window_us=1000.0):
    ops = [(n, ts, d) for n, ts, d in kernels]
    return Trace(window_us=window_us, kernels=ops, device_ops=ops,
                 busy_us=sum(d for _, _, d in ops), gaps=[])


def test_readers_on_a_made_up_trace():
    cfg = manifest.read_json(manifest.config_path("fastegnn-water3d"))
    # two steps of one graph batch: 8000 rows, 400,000 edges
    shapes = [(1, 8000, 400_000, 8000)] * 2
    fwd_s = roofline.edge_bound_s("fwd", False, 8000, 400_000, 2)
    kernels = [("edge_fwd_kernel(float const*)", 0.0, 2 * fwd_s * 1e6),
               ("sm80_xmma_gemm", 10.0, 30.0), ("segment_sum_kernel<float>", 50.0, 20.0)]
    ctx = {"cfg": cfg, "trace": {"trace": _trace(kernels), "steps": 2, "shapes": shapes},
           "window": {"dispatch_s": [0.1, 0.3], "collate_s": [], "steps": 2, "seconds": 1.0,
                      "shapes": shapes}, "counter": manifest.counter("fastegnn-water3d")}
    read = {n: manifest.metric_reader(n).read(ctx) for n in
            ("edge_fwd_roofline", "edge_bwd_roofline", "other_kernels_ms", "dispatch_ms",
             "collate_ms", "device_idle_share", "step_mfu")}
    assert read["edge_fwd_roofline"] == pytest.approx(50.0)
    assert read["edge_bwd_roofline"] is None           # no launch in the window
    assert read["other_kernels_ms"] == pytest.approx(0.015)
    assert read["dispatch_ms"] == pytest.approx(200.0)
    assert read["collate_ms"] is None
    busy = 2 * fwd_s * 1e6 + 50.0
    assert read["device_idle_share"] == pytest.approx(100 * (1 - busy / 1000.0))
    flops = 2 * manifest.counter("fastegnn-water3d").step_flops(cfg, 1, 8000, 400_000)
    assert read["step_mfu"] == pytest.approx(100 * flops / 67e12)


def test_trace_union_and_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.next_batch", "ts": 30, "dur": 40},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10}]
    tr = parse(ev)
    assert tr.window_us == 100 and tr.busy_us == 40
    assert [k[0] for k in tr.kernels] == ["a", "b"]
    assert tr.gaps == [("bench.next_batch", 50.0), ("host other", 10.0)]
