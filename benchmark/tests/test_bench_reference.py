"""The plain references against the port at a tiny size on the CPU: the
same forward from the same weights and graphs, the port's collated batch
against the graphs rebuilt from the raw frames, and a batch altered in
one entry found."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, manifest
from benchmark.reference import common
from benchmark.weights import load_into, make_weights

CONFIGS = ["fastegnn-water3d", "fasttfn-protein"]


def _setup(tiny_dir, name, seed=5):
    cfg = manifest.read_json(manifest.config_path(name, tiny_dir))
    dev = torch.device("cpu")
    ds, raw = inputs.build(cfg, seed, dev)
    model, _, _ = harness.build_program(cfg, ds.spec, dev)
    weights = make_weights({n: p.shape for n, p in model.named_parameters()}, cfg["init"],
                           seed, dev)
    load_into(model, weights)
    graphs = [common.rebuild_graph(r, cfg["radius"], cfg["cutoff_rate"], dev)
              for r in raw.graphs]
    return cfg, ds, model, weights, graphs


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_the_port(tiny_dir, name):
    cfg, ds, model, weights, graphs = _setup(tiny_dir, name)
    idx = [3, 1]
    batch = ds.collate(idx)
    with torch.no_grad():
        x, vx = model(batch)
        m = batch.num_nodes // 2
        fwd = manifest.reference(name).forward
        for g, i in enumerate(idx):
            rx, rvx = fwd(weights, graphs[i], cfg)
            n = graphs[i].n
            scale = float((graphs[i].loc - graphs[i].loc.mean(0)).abs().max())
            assert float((x[g * m:g * m + n] - rx).abs().max()) < 1e-5 * scale
            assert float((vx[g].T - rvx).abs().max()) < 1e-5 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_batch_check_passes_the_port_and_finds_an_altered_entry(tiny_dir, name):
    cfg, ds, _, _, graphs = _setup(tiny_dir, name)
    idx = [0, 4]
    hb = common.host_batch(ds.collate(idx))
    ok = common.batch_mismatch(hb, [graphs[i] for i in idx], cfg["cutoff_rate"])
    assert sum(ok.values()) == 0, ok
    for field, change in (("coord_target", lambda a: a.__setitem__((5, 1), a[5, 1] + 1e-3)),
                          ("src", lambda a: a.__setitem__(7, (a[7] + 1) % (len(a) or 1))),
                          ("edge_attr", lambda a: a.__setitem__((2, 0), a[2, 0] * 1.01))):
        bad = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in hb.items()}
        change(bad[field])
        found = common.batch_mismatch(bad, [graphs[i] for i in idx], cfg["cutoff_rate"])
        assert sum(found.values()) > 0, field


def test_adam_matches_torch():
    torch.manual_seed(0)
    p = {"w": torch.randn(5, 3)}
    q = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.Adam([q], lr=5e-4, weight_decay=1e-3)
    ours = common.Adam({"w": p["w"].clone()}, 5e-4, 1e-3)
    for _ in range(3):
        g = torch.randn(5, 3)
        q.grad = g.clone()
        opt.step()
        ours.step({"w": g})
    assert torch.allclose(ours.p["w"], q.detach(), rtol=0, atol=1e-7)
