"""The port's Water-3D matched-parity harness against the JAX package's.

``scripts/parity_simulation.py::run_jax`` runs unchanged under
``MATCHED`` on a tiny trio that its own ``ensure_data`` writes (its
``DATA``, ``PROTOCOL_PATH`` and ``HP`` set for it: 1 trajectory per split
of 100 particles and 300 frames, one layer so that the JAX steps compile
quickly, batch 5, an eval every epoch, 3 epochs);
``scripts/torch_parity_simulation.py::run_port`` then trains the port from
the same weights (the JAX harness's init, carried over by
``state_dict_from_jax_params``), each step handed the JAX step's per-graph
MMD draw from the loop's host key, and the two ``[best, log]`` must agree.
At full size the port's protocol is the JAX script's file byte for byte
and its splits are the JAX splits built from the h5 trio, array for array.
The report's criteria, the harness's device rule, its resume and its
imports are held here too, and the JAX harness's full-size inits of seeds
43-47 committed in ``docs/parity_port/water3d_jax_init_s<seed>.npz``,
which the port's ``--init`` starts from.  Run as a script, this file
writes those ``.npz`` files anew::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_port_parity_water3d.py
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastegnn_tpu.data.simulation import SimulationDataset as JSimulationDataset
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 3
INIT_SEEDS = (43, 44, 45, 46, 47)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jharness = _script("parity_simulation")
pharness = _script("torch_parity_simulation")
report = _script("torch_parity_report")
TINY = dict(n_traj=1, n_particles=100, n_frames=300, layers=1, batch_size=5,
            test_interval=1, early_stop=10**9)
JHP, PHP = dict(jharness.HP, **TINY), dict(pharness.HP, **TINY)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: on these tiny graphs a busy host's thread
    pool costs more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_tiny(monkeypatch, tmp_path):
    """The JAX harness's module set to the tiny trio under ``tmp_path``."""
    monkeypatch.setattr(jharness, "DATA", str(tmp_path / "data"))
    monkeypatch.setattr(jharness, "PROTOCOL_PATH", str(tmp_path / "jax_protocol.json"))
    monkeypatch.setattr(jharness, "MATCHED", True)
    monkeypatch.setattr(jharness, "HP", JHP)
    return tmp_path


@pytest.fixture(scope="module")
def jax_full(tmp_path_factory):
    """The JAX script's full-size h5 trio and the protocol its
    ``ensure_protocol`` writes from it, under a temporary directory."""
    root = tmp_path_factory.mktemp("water3d")
    saved = jharness.DATA, jharness.PROTOCOL_PATH
    jharness.DATA, jharness.PROTOCOL_PATH = str(root / "data"), str(root / "protocol.json")
    try:
        jharness.ensure_data()
        proto = jharness.ensure_protocol()
    finally:
        jharness.DATA, jharness.PROTOCOL_PATH = saved
    return root, proto


def _jax_draw(key, graph):
    """The scores the JAX step draws from the loop's host key
    (``fastegnn_tpu/train/loss.py:73``)."""
    key = jax.random.wrap_key_data(jnp.asarray(key))
    return torch.tensor(np.asarray(
        jax.random.uniform(key, (graph.n_graphs, graph.num_nodes // graph.n_graphs))))


def _jax_init():
    """The weights ``run_jax`` starts from, in the port's layout."""
    proto = jharness.ensure_protocol()
    dtr = JSimulationDataset(jharness.DATA, "Water-3D", partition="train",
                             virtual_channels=JHP["channels"], cutoff_rate=JHP["cutoff"],
                             delta_t=JHP["delta_t"], seed=43, protocol=proto["train"])
    model = JFastEGNN(hidden=JHP["hidden"], virtual_channels=JHP["channels"],
                      n_layers=JHP["layers"], gravity=jharness.GRAVITY)
    params = jax.jit(model.init)(jax.random.key(43),
                                 dtr.collate(list(range(JHP["batch_size"]))))["params"]
    return state_dict_from_jax_params(jax.tree.map(np.asarray, params))


def _flat(tree, prefix=""):
    """``{"a/b/c": array}`` of a nested param dict (``load_jax_init``'s
    layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_matched_inits(data, protocol, seeds=INIT_SEEDS):
    """``{seed: params}`` (numpy) that ``run_jax`` under ``--matched`` starts
    from at full size (``scripts/parity_simulation.py:285-292``), on the
    trio in ``data`` replayed through ``protocol``."""
    hp = jharness.HP
    dtr = JSimulationDataset(data, "Water-3D", partition="train",
                             virtual_channels=hp["channels"], cutoff_rate=hp["cutoff"],
                             delta_t=hp["delta_t"], seed=43, protocol=protocol["train"])
    model = JFastEGNN(hidden=hp["hidden"], virtual_channels=hp["channels"],
                      n_layers=hp["layers"], gravity=jharness.GRAVITY)
    example = dtr.collate(list(range(hp["batch_size"])))
    init = jax.jit(model.init)
    return {s: jax.tree.map(np.asarray, init(jax.random.key(s), example)["params"])
            for s in seeds}


def _init_path(seed):
    return REPO / "docs" / "parity_port" / f"water3d_jax_init_s{seed}.npz"


def _port(out, epochs=EPOCHS, **kw):
    kw.setdefault("protocol_path", str(Path(out).parent / "port_protocol.json"))
    return pharness.run_port(epochs, str(out), "cpu", 43, hp=PHP, **kw)


# The logged MSEs are 2.4e-3 - 4.9e-3 here.  Measured gap (every logged
# train and test MSE and the best dict's three losses, relative) over data
# seeds 7 (the harness's) and 3: 5.7e-6 / 5.1e-6.  rtol 3e-5, the Water-3D loop
# test's (test_torch_port_loop.py): Adam's first updates are lr * sign(g),
# which the two packages can take opposite ways where |g| is at rounding
# noise.
def test_port_harness_tracks_the_jax_harness(jax_tiny):
    jharness.run_jax(EPOCHS, str(jax_tiny / "jax.json"), platform="cpu", seed=43)
    with open(jax_tiny / "jax.json") as f:
        jbest, jlog = json.load(f)
    pbest, plog = _port(jax_tiny / "port.json", state_dict=_jax_init(), draw_fn=_jax_draw)
    # the port drew the JAX script's protocol from its in-memory trio
    assert (jax_tiny / "port_protocol.json").read_bytes() == \
        (jax_tiny / "jax_protocol.json").read_bytes()
    with open(jax_tiny / "port.json") as f:
        assert json.load(f) == [pbest, plog]
    assert plog["epochs"] == jlog["epochs"] == [1, 2, 3]
    assert sorted(plog) == sorted(jlog) == ["epochs", "loss", "loss_train"]
    tol = dict(rtol=3e-5)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], **tol)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], **tol)
    assert pbest["epoch_index"] == jbest["epoch_index"]
    for k in ("loss_valid", "loss_test", "loss_train"):
        np.testing.assert_allclose(pbest[k], jbest[k], **tol)
    assert (pbest["model"], pbest["seed"], pbest["epochs_run"], pbest["device"]) == (
        "FastEGNN", 43, EPOCHS, "cpu")
    assert pbest["time_cost"] > 0 and pbest["seconds_per_epoch"] > 0


def test_protocol_is_the_jax_scripts_file_byte_for_byte(jax_full, tmp_path):
    root, proto = jax_full
    jax_bytes = (root / "protocol.json").read_bytes()
    drawn = pharness.ensure_protocol(str(tmp_path / "p.json"), pharness.trajectories())
    assert drawn == proto
    assert (tmp_path / "p.json").read_bytes() == jax_bytes
    assert Path(pharness.PROTOCOL_PATH).read_bytes() == jax_bytes
    # 4 trajectories of 15 frames per split
    assert [len(proto[s]["order"]) for s in ("train", "valid", "test")] == [60, 60, 60]


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_splits_are_the_jax_splits_exactly(jax_full, split):
    root, proto = jax_full
    jds = JSimulationDataset(str(root / "data"), "Water-3D", partition=split,
                             virtual_channels=3, cutoff_rate=0.0, delta_t=20,
                             seed=dict(train=43, valid=44, test=45)[split],
                             protocol=proto[split])
    sets, sha = pharness.load_datasets("cpu")
    pds = sets[("train", "valid", "test").index(split)]
    assert sha == "14511b6e83a72fca"
    assert (jds.spec.max_nodes, jds.spec.max_edges) == (pds.spec.max_nodes, pds.spec.max_edges)
    assert len(jds) == len(pds) == 60
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def full_inits(jax_full):
    root, proto = jax_full
    return jax_matched_inits(str(root / "data"), proto)


@pytest.mark.parametrize("seed", INIT_SEEDS)
def test_committed_jax_inits_are_the_jax_harness_inits(full_inits, seed):
    want = _flat(full_inits[seed])
    with np.load(_init_path(seed)) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_init_option_starts_from_the_jax_init(full_inits, tmp_path):
    """``--init`` loads the committed file into the port's layout, and the
    run is the one handed those weights as a ``state_dict``."""
    want = state_dict_from_jax_params(full_inits[44])
    got = pharness.load_jax_init(str(_init_path(44)))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    pharness.main(["--platform", "cpu", "--epochs", "1", "--seed", "44", "--init",
                   str(_init_path(44)), "--out", str(tmp_path / "init.json")])
    best, log = pharness.run_port(1, str(tmp_path / "sd.json"), "cpu", 44, state_dict=want)
    with open(tmp_path / "init.json") as f:
        ibest, ilog = json.load(f)
    assert ilog == log
    assert ibest["loss_test"] == best["loss_test"]


def test_resume_goes_on_as_the_uninterrupted_run(tmp_path):
    best, log = _port(tmp_path / "whole.json")
    out = tmp_path / "cut.json"
    _port(out, epochs=2)
    assert (tmp_path / "cut_ckpt" / "last").exists()
    assert (tmp_path / "cut_live.json").exists()
    rbest, rlog = _port(out, resume=True)
    assert rlog == log
    timing = ("time_cost", "seconds_per_epoch", "step_ms_median")
    assert {k: v for k, v in rbest.items() if k not in timing} == \
        {k: v for k, v in best.items() if k not in timing}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _port(tmp_path / "none.json", resume=True)


def test_harness_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--epochs", "1", "--out", str(tmp_path / "a.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pharness.main(argv)
    assert not (tmp_path / "a.json").exists()


def _run(path, losses, best_test, epochs=None, **facts):
    epochs = epochs or [5 * (i + 1) for i in range(len(losses))]
    best = dict(epoch_index=epochs[-1], loss_valid=best_test, loss_test=best_test,
                loss_train=0.1, **facts)
    with open(path, "w") as f:
        json.dump([best, dict(epochs=epochs, loss=losses, loss_train=[0.1] * epochs[-1])], f)


def test_report_criteria_arithmetic(tmp_path):
    exp = dict(report.WATER3D, seeds=(43, 44, 45), band_until=10, marks=(5, 10, 15))
    root = str(tmp_path)
    # JAX at epochs 5 / 10 / 15: medians 1.0 / 2.0; largest deviation up to
    # epoch 10 is 0.2 (epoch 10, 1.6 against 2.0); epoch 15 lies outside it
    for s, losses, b in ((43, [1.0, 2.0, 9.0], 0.5), (44, [0.97, 1.6, 1.0], 0.3),
                         (45, [1.03, 2.1, 1.0], 0.4)):
        _run(report.seeds_path(root, "water3d", "jax", s), losses, b)
    assert "*(no run of the port yet)*" in report.seeds_lines(root, exp)
    jax_runs = [report.load(report.seeds_path(root, "water3d", "jax", s)) for s in exp["seeds"]]
    half, at = report.seed_band([log for _, log in jax_runs], 10, 0.05)
    assert half == pytest.approx(0.2) and at == 10
    # the floor holds when the seeds agree closely
    assert report.seed_band([log for _, log in jax_runs], 5, 0.05) == (0.05, None)
    # port medians 1.1 / 2.3: ratios 1.1 and 1.15, inside 1 +- 0.2; best
    # median 0.45 inside [0.3, 0.5]
    for s, losses, b in ((43, [1.1, 2.3], 0.45), (44, [1.0, 2.2], 0.6),
                         (45, [1.3, 2.5], 0.2)):
        _run(report.seeds_path(root, "water3d", "fastegnn", s), losses, b)
    port_runs = [report.load(report.seeds_path(root, "water3d", "fastegnn", s))
                 for s in exp["seeds"]]
    c = report.seed_criteria(jax_runs, port_runs, 10, 0.05)
    assert c["port_median"] == 0.45 and (c["jax_min"], c["jax_max"]) == (0.3, 0.5)
    assert c["a"] and c["b"]
    assert [(e, round(r, 6), ok) for e, r, ok in c["b_rows"]] == [(5, 1.1, True),
                                                                 (10, 1.15, True)]
    text = "\n".join(report.seeds_lines(root, exp))
    assert "[0.8000, 1.2000]" in text and "**pass**" in text and "**fail**" not in text
    assert "In plain words: both criteria pass" in text
    assert "| 15 | 9.000000 | 1.000000 | 1.000000 | — | — | — | 1.000000 | — |" in text
    # a port median outside the JAX range fails (a); a ratio past the band, (b)
    _run(report.seeds_path(root, "water3d", "fastegnn", 44), [1.0, 2.6], 0.9)
    _run(report.seeds_path(root, "water3d", "fastegnn", 45), [1.3, 2.5], 0.8)
    port_runs = [report.load(report.seeds_path(root, "water3d", "fastegnn", s))
                 for s in exp["seeds"]]
    c = report.seed_criteria(jax_runs, port_runs, 10, 0.05)
    assert c["port_median"] == 0.8 and not c["a"]
    assert c["b_rows"][1][1] == pytest.approx(1.25) and not c["b"]
    assert "In plain words: the port fails (a) and (b)." in "\n".join(
        report.seeds_lines(root, exp))
    # more seeds a side are reported beside the criterion, which they leave
    assert "Beside the criterion" not in text
    _run(report.seeds_path(root, "water3d", "jax", 48), [1.0, 2.0], 0.1)
    _run(report.seeds_path(root, "water3d", "fastegnn", 48), [1.0, 2.0], 0.7)
    text = "\n".join(report.seeds_lines(root, exp))
    assert ("Beside the criterion, over seeds 43-52: the JAX median best test MSE 0.350000 "
            "over 4 seeds, range [0.100000, 0.500000]; the port's 0.750000 over 4 seeds, "
            "range [0.450000, 0.900000].") in text
    assert "the port fails (a) and (b)." in text
    report.main(["--dir", root, "--jax_dir", str(REPO / "docs" / "parity")])
    assert "Water-3D matched protocol" in (tmp_path / "PARITY.md").read_text()


def test_report_sets_the_jax_init_runs_beside_the_jax_seeds(tmp_path):
    exp = dict(report.WATER3D, seeds=(43, 44, 45))
    root = str(tmp_path)
    assert "*(no run of the port from the JAX inits yet)*" in report.jax_init_lines(root, exp)
    # test MSEs at epochs 5 / 10 / 15; the plateau breaks under 0.8e-3
    for s, losses, b in ((43, [2e-3, 7e-4, 3e-4], 3e-4), (44, [9e-4, 8e-4, 5e-4], 5e-4),
                         (45, [1e-3, 1e-3, 9e-4], 9e-4)):
        _run(report.seeds_path(root, "water3d", "jax", s), losses, b)
    for s, losses, b in ((43, [1e-3, 6e-4, 4e-4], 4e-4), (44, [7e-4, 6e-4, 6e-4], 6e-4)):
        _run(str(tmp_path / f"water3d_fastegnn_jaxinit_s{s}.json"), losses, b, device="card")
    _run(report.seeds_path(root, "water3d", "fastegnn", 43), [1e-3, 1e-3, 2e-4], 2e-4)
    assert report.plateau_break({"epochs": [5, 10, 15], "loss": [9e-4, 8e-4, 7e-4]}) == 15
    assert report.plateau_break({"epochs": [5, 10], "loss": [9e-4, 8e-4]}) is None
    text = "\n".join(report.jax_init_lines(root, exp))
    assert "| 43 | 0.000300 | 10 | 0.000400 | 10 | 0.000200 | 15 | card |" in text
    assert "| 44 | 0.000500 | 15 | 0.000600 | 5 | — | — | card |" in text
    # median of 0.0004 and 0.0006 against the JAX range [0.0003, 0.0009]
    assert ("- port from the JAX inits, median best test MSE over seeds [43, 44]: "
            "**0.000500** (seeds [45] not run), inside the JAX range [0.000300, 0.000900].") \
        in text


def test_harness_and_report_import_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, 'scripts')\n"
        "import torch_parity_simulation as h, torch_parity_report\n"
        f"h.run_port(1, {str(tmp_path / 'x.json')!r}, 'cpu', hp={PHP!r}, "
        f"protocol_path={str(tmp_path / 'p.json')!r})\n"
        f"torch_parity_report.main(['--dir', {str(tmp_path)!r}])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fastegnn_tpu', 'h5py')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO), env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


if __name__ == "__main__":
    # the committed inits, from the JAX script's own trio and protocol
    trio, protocol = jharness.ensure_data(), jharness.ensure_protocol()
    for seed, params in jax_matched_inits(trio, protocol).items():
        np.savez_compressed(_init_path(seed), **_flat(params))
        print(f"wrote {_init_path(seed)}")
