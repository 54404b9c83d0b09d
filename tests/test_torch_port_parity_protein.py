"""The port's protein converged-parity harness against the JAX package's.

``scripts/parity_protein.py::run_jax`` runs unchanged on a tiny npz that
its own ``ensure_data`` writes (its ``NPZ`` and ``HP`` set for it: 20
atoms and 120 frames, one layer so that the JAX steps compile quickly,
batch 5, an eval every epoch, 3 epochs); ``scripts/parity_protein_jax.py``
at seed 43 must write the same JSON.  ``scripts/torch_parity_protein.py::
run_port`` then trains the port from the same weights (the JAX harness's
init, carried over by ``state_dict_from_jax_params``), each step handed the
JAX step's shared MMD draw from the loop's host key, and the two
``[best, log]`` must agree.  At full size the committed npz is the port's
generator output and the port's splits are the JAX harness's, array for
array.  The report's protein criteria, the harness's device rule, its
resume and its imports are held here too.
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

from fastegnn_tpu.data.protein import ProteinDataset as JProteinDataset
from fastegnn_tpu.models import FastEGNN as JFastEGNN
from fastegnn_tpu_torch.data.protein import make_synthetic_protein_npz
from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 3
SPLITS = ("train", "valid", "test")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jseeds = _script("parity_protein_jax")
jharness = jseeds.pp          # scripts/parity_protein.py, as the seed script reads it
pharness = _script("torch_parity_protein")
report = _script("torch_parity_report")
# 120 frames, delta_frame 15: 104 usable, 61 / 20 / 21 samples
TINY = dict(n_atoms=20, n_frames=120, layers=1, batch_size=5, test_interval=1)
JHP, PHP = dict(jharness.HP, **TINY), dict(pharness.HP, **TINY)
TIMING = ("time_cost", "seconds_per_epoch", "step_ms_median")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: on these tiny graphs a busy host's thread
    pool costs more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_splits(npz, hp):
    """The three splits ``run_jax`` builds (``parity_protein.py:288-293``)."""
    return [JProteinDataset(npz, partition=part, virtual_channels=hp["channels"],
                            cutoff_rate=hp["cutoff"], delta_frame=hp["delta_frame"],
                            contact_cutoff=hp["contact_cutoff"], test_rot=True,
                            test_trans=True, seed=seed)
            for part, seed in zip(SPLITS, (43, 44, 45))]


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """``run_jax`` and the seed script at 43 on the tiny npz, which
    ``ensure_data`` writes; the weights ``run_jax`` starts from, in the
    port's layout."""
    root = tmp_path_factory.mktemp("protein")
    saved = jharness.NPZ, jharness.HP
    jharness.NPZ, jharness.HP = str(root / "tiny.npz"), JHP
    try:
        jharness.run_jax(EPOCHS, str(root / "jax.json"), platform="cpu")
        jseeds.run_jax(EPOCHS, str(root / "seed43.json"), platform="cpu", seed=43)
        dtr = _jax_splits(jharness.NPZ, JHP)[0]
        model = JFastEGNN(hidden=JHP["hidden"], virtual_channels=JHP["channels"],
                          n_layers=JHP["layers"])
        params = jax.jit(model.init)(jax.random.key(43),
                                     dtr.collate(list(range(JHP["batch_size"]))))["params"]
    finally:
        jharness.NPZ, jharness.HP = saved
    return root, state_dict_from_jax_params(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """The tiny npz as the port's harness writes it."""
    return pharness.ensure_npz(str(tmp_path_factory.mktemp("port") / "tiny.npz"), PHP)


def _jax_draw(key, graph):
    """The shared permutation the JAX step draws from the loop's host key
    (``fastegnn_tpu/train/loss.py:78``)."""
    key = jax.random.wrap_key_data(jnp.asarray(key))
    return torch.tensor(np.asarray(
        jax.random.permutation(key, graph.num_nodes // graph.n_graphs)))


def _port(out, npz, epochs=EPOCHS, **kw):
    return pharness.run_port(epochs, str(out), "cpu", 43, hp=PHP, npz=npz, **kw)


def _load(path):
    with open(path) as f:
        return json.load(f)


# The logged MSEs are 3.8e-2 - 4.4e-2 here.  Measured gap (every logged
# train and test MSE and the best dict's three losses, relative): 7.9e-7;
# with the port's own MMD draws in place of the JAX ones, 5.2e-3.
# rtol 3e-5, the Water-3D harness test's: Adam's first updates are
# lr * sign(g), which the two packages can take opposite ways where |g| is
# at rounding noise.
def test_port_harness_tracks_the_jax_harness(jax_tiny, tiny_npz, tmp_path):
    root, init = jax_tiny
    # the port's generator wrote the npz the JAX ensure_data wrote
    with np.load(root / "tiny.npz") as a, np.load(tiny_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jbest, jlog = _load(root / "jax.json")
    pbest, plog = _port(tmp_path / "port.json", tiny_npz, state_dict=init, draw_fn=_jax_draw)
    assert _load(tmp_path / "port.json") == [pbest, plog]
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


def test_seed_script_at_43_is_run_jax(jax_tiny):
    root, _ = jax_tiny
    (jbest, jlog), (sbest, slog) = _load(root / "jax.json"), _load(root / "seed43.json")
    assert slog == jlog
    assert {k: v for k, v in sbest.items() if k != "time_cost"} == \
        {k: v for k, v in jbest.items() if k != "time_cost"}


def test_committed_npz_is_the_ports_generator_output(tmp_path):
    hp = pharness.HP
    make_synthetic_protein_npz(str(tmp_path / "adk.npz"), n_atoms=hp["n_atoms"],
                               n_frames=hp["n_frames"], seed=pharness.NPZ_SEED)
    with np.load(pharness.NPZ) as a, np.load(tmp_path / "adk.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["positions"].shape == (4187, 60, 3)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def full_splits():
    """The full-size splits of each side, on the committed npz."""
    sets, sha = pharness.load_datasets(torch.device("cpu"))
    return _jax_splits(pharness.NPZ, jharness.HP), sets, sha


@pytest.mark.parametrize("split", SPLITS)
def test_full_size_splits_are_the_jax_splits_exactly(full_splits, split):
    jsets, psets, sha = full_splits
    i = SPLITS.index(split)
    jds, pds = jsets[i], psets[i]
    assert len(sha) == 16
    assert (jds.spec.max_nodes, jds.spec.max_edges) == (pds.spec.max_nodes, pds.spec.max_edges)
    assert len(jds) == len(pds) == (2481, 827, 863)[i]
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_resume_goes_on_as_the_uninterrupted_run(tiny_npz, tmp_path):
    best, log = _port(tmp_path / "whole.json", tiny_npz)
    out = tmp_path / "cut.json"
    _port(out, tiny_npz, epochs=2)
    assert (tmp_path / "cut_ckpt" / "last").exists()
    assert (tmp_path / "cut_live.json").exists()
    rbest, rlog = _port(out, tiny_npz, resume=True)
    assert rlog == log
    assert {k: v for k, v in rbest.items() if k not in TIMING} == \
        {k: v for k, v in best.items() if k not in TIMING}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _port(tmp_path / "none.json", tiny_npz, resume=True)


def test_harness_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--epochs", "1", "--out", str(tmp_path / "a.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pharness.main(argv)
    assert not (tmp_path / "a.json").exists()


def _run(path, losses, best_test):
    """A hand-made ``[best, log]`` with test MSEs at epochs 25 / 50 / 100 / 150."""
    epochs = [25, 50, 100, 150][:len(losses)]
    best = dict(epoch_index=epochs[-1], loss_valid=best_test, loss_test=best_test,
                loss_train=0.1)
    with open(path, "w") as f:
        json.dump([best, dict(epochs=epochs, loss=losses, loss_train=[0.1] * epochs[-1])], f)


def test_report_protein_criteria(tmp_path):
    exp = dict(report.PROTEIN, seeds=(43, 44, 45))
    root = str(tmp_path)

    def path(side, s):
        return report.seeds_path(root, "protein", side, s)

    # JAX at epochs 25 / 50 / 100 / 150, seed 45 early-stopped after 100:
    # medians 1.0 / 2.0 / 1.0 at the epochs all three logged; the largest
    # deviation is 0.2 (epoch 50, 1.6 against 2.0)
    for s, losses, b in ((43, [1.0, 2.0, 1.0, 1.0], 0.5), (44, [0.97, 1.6, 1.05, 1.0], 0.3),
                         (45, [1.03, 2.1, 0.95], 0.4)):
        _run(path("jax", s), losses, b)
    assert "*(no run of the port yet)*" in report.seeds_lines(root, exp)
    # port medians 1.1 / 2.3 / 1.0, ratios 1.1 / 1.15 / 1.0; epoch 150 is
    # left out: not every run logged it.  Best median 0.45 in [0.3, 0.5].
    for s, losses, b in ((43, [1.1, 2.3, 1.0, 1.0], 0.45), (44, [1.0, 2.2, 1.0, 1.0], 0.6),
                         (45, [1.3, 2.5, 1.0, 9.0], 0.2)):
        _run(path("fastegnn", s), losses, b)
    text = "\n".join(report.seeds_lines(root, exp))
    assert "## Protein, synthetic AdK chain, FastEGNN (shared MMD draw) (cap 150 epochs)" in text
    assert "[0.8000, 1.2000]: the JAX seeds' largest deviation from their median there " \
           "(0.2000, at epoch 50)" in text
    assert "- (a) port median best test MSE over seeds [43, 44, 45]: **0.450000**, **pass**: " \
           "the JAX range is [0.300000, 0.500000]." in text
    assert "- (b) 3 logged epochs <= 150; the farthest ratio 1.1500 at epoch 50; 0 outside " \
           "[0.8000, 1.2000]: **pass**." in text
    assert "In plain words: both criteria pass; the port converges on the synthetic AdK " \
           "chain as the JAX package does." in text
    assert "| 150 | 1.000000 | 1.000000 | — | 1.000000 | 1.000000 | 9.000000 | — | 1.000000 |" \
        in text
    # a port median outside the JAX range fails (a); a ratio past the band, (b)
    _run(path("fastegnn", 44), [1.0, 2.6, 1.0, 1.0], 0.9)
    _run(path("fastegnn", 45), [1.3, 2.5, 1.0], 0.8)
    text = "\n".join(report.seeds_lines(root, exp))
    assert "**0.800000**, **fail**" in text
    assert "the farthest ratio 1.2500 at epoch 50; 1 outside" in text
    assert "In plain words: the port fails (a) and (b)." in text
    # the floor holds where the JAX seeds agree more closely than it
    jax_logs = [report.load(path("jax", s))[1] for s in exp["seeds"]]
    assert report.seed_band(jax_logs, 25, 0.05) == (0.05, None)
    report.main(["--dir", root, "--jax_dir", str(REPO / "docs" / "parity")])
    assert "## Protein, synthetic AdK chain" in (tmp_path / "PARITY.md").read_text()


def test_harness_and_report_import_no_jax(tiny_npz, tmp_path):
    code = (
        "import sys; sys.path.insert(0, 'scripts')\n"
        "import torch_parity_protein as h, torch_parity_report\n"
        f"h.run_port(1, {str(tmp_path / 'x.json')!r}, 'cpu', hp={PHP!r}, npz={tiny_npz!r})\n"
        f"torch_parity_report.main(['--dir', {str(tmp_path)!r}])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'fastegnn_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO), env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
