"""The port's converged-parity harness against the JAX package's.

``scripts/parity_nbody.py::run_jax`` runs unchanged on a tiny serial
5-particle set written by the port's generator (its ``DATA``, ``NAME``,
``MODEL`` and ``HP`` set for it: 16 / 8 / 8 trajectories, batch 4, one
layer so that the JAX steps compile quickly, an eval every epoch, 3
epochs); ``scripts/torch_parity_nbody.py::run_port`` then trains the port
from the same weights (the JAX harness's init, carried over by
``utils/weights.py``), and the two ``[best, log]`` must agree.  With 5
particles the MMD sample (3 per virtual channel) takes every node, so the
two packages' draws differ only in their order.  The report's arithmetic,
the harness's fibonacci positions, its device rule, its resume and its
imports are held here too.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fastegnn_tpu.models import get_model as jget_model
from fastegnn_tpu_torch.data import nbody_sim as psim
from fastegnn_tpu_torch.utils.weights import (
    state_dict_from_egnn_params,
    state_dict_from_jax_params,
    state_dict_from_vnegnn_params,
)

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 3
INVERSE = {"FastEGNN": state_dict_from_jax_params, "EGNN": state_dict_from_egnn_params,
           "VNEGNN": state_dict_from_vnegnn_params}


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jharness = _script("parity_nbody")
pharness = _script("torch_parity_nbody")
report = _script("torch_parity_report")
HP = dict(jharness.HP, batch_size=4, layers=1, test_interval=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: on these tiny graphs a busy host's thread
    pool costs more than the work (8 threads: ~60 ms per index_add)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(num_train=16, num_valid=8, num_test=8, length=410, sample_freq=10)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """16 / 8 / 8 serial trajectories of 5 particles (41 frames, so that
    frames 30 and 40 exist), written by the harness's ``ensure_dataset``."""
    root = str(tmp_path_factory.mktemp("parity"))
    pharness.ensure_dataset(root, "5_0_0", 1, **TINY)
    return root, "5_0_0"


@pytest.fixture
def jax_harness(monkeypatch, data):
    """The JAX harness's module with its globals set to ``data`` and ``HP``;
    returns a setter for ``MODEL``."""
    root, name = data
    monkeypatch.setattr(jharness, "DATA", root)
    monkeypatch.setattr(jharness, "NAME", name)
    monkeypatch.setattr(jharness, "HP", HP)
    return lambda model: monkeypatch.setattr(jharness, "MODEL", model)


def _jax_init(model):
    """The weights ``run_jax`` starts from, in the port's layout."""
    dtr = jharness.load_datasets()[0]
    jm = jget_model(model, hidden=HP["hidden"], virtual_channels=HP["channels"],
                    n_layers=HP["layers"])
    example = dtr.collate(list(range(HP["batch_size"])))
    params = jax.jit(jm.init)(jax.random.key(43), example)["params"]
    return INVERSE[model](jax.tree.map(np.asarray, params))


def _port(data, out, model="FastEGNN", **kw):
    root, name = data
    return pharness.run_port(EPOCHS, str(out), "cpu", 43, data=root, name=name, model=model,
                             hp=HP, **kw)


# The logged MSEs are 8e-5 - 3.2e-2 here.  Measured gap (every logged
# train and test MSE and the best dict's three losses, relative) over data
# seeds 42 (this file's) and 7: FastEGNN 2.5e-5 / 4.0e-5, EGNN 1.9e-5 /
# 7.0e-5, VNEGNN 4.5e-7 / 2.8e-7.  rtol 2e-4, the N-body loop test's
# (test_torch_port_nbody.py): Adam's first updates are lr * sign(g), which
# the two packages can take opposite ways where |g| is at rounding noise.
@pytest.mark.parametrize("model", ["FastEGNN", "EGNN", "VNEGNN"])
def test_port_harness_tracks_the_jax_harness(jax_harness, data, tmp_path, model):
    jax_harness(model)
    jharness.run_jax(EPOCHS, str(tmp_path / "jax.json"), platform="cpu", seed=43)
    with open(tmp_path / "jax.json") as f:
        jbest, jlog = json.load(f)
    pbest, plog = _port(data, tmp_path / "port.json", model, state_dict=_jax_init(model))
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == [pbest, plog]
    assert plog["epochs"] == jlog["epochs"] == [1, 2, 3]
    assert sorted(plog) == sorted(jlog) == ["epochs", "loss", "loss_train"]
    tol = dict(rtol=2e-4)
    np.testing.assert_allclose(plog["loss_train"], jlog["loss_train"], **tol)
    np.testing.assert_allclose(plog["loss"], jlog["loss"], **tol)
    assert pbest["epoch_index"] == jbest["epoch_index"]
    for k in ("loss_valid", "loss_test", "loss_train"):
        np.testing.assert_allclose(pbest[k], jbest[k], **tol)
    assert (pbest["model"], pbest["seed"], pbest["epochs_run"], pbest["device"]) == (
        model, 43, EPOCHS, "cpu")
    assert pbest["time_cost"] > 0 and pbest["seconds_per_epoch"] > 0


def test_fibonacci_positions_are_the_jax_harness_positions(jax_harness, data):
    jax_harness("VNEGNN")
    jbatch = jharness.load_datasets()[0].collate([0, 1, 2, 3])
    root, name = data
    dtr = pharness.load_datasets(root, name, "VNEGNN", torch.device("cpu"), HP)[0]
    batch = dtr.collate([0, 1, 2, 3])
    assert batch.virtual_fibonacci.dtype == torch.float32
    np.testing.assert_array_equal(batch.virtual_fibonacci.numpy(),
                                  np.asarray(jbatch.virtual_fibonacci))
    for i in range(4):
        want = jharness.fibonacci_positions(np.asarray(dtr.graphs[i]["coord"], np.float64),
                                            HP["channels"]).T.astype(np.float32)
        np.testing.assert_array_equal(batch.virtual_fibonacci[i].numpy(), want)
    # the other models' graphs carry none
    assert pharness.load_datasets(root, name, "EGNN", "cpu", HP)[0].collate(
        [0, 1]).virtual_fibonacci is None


def test_resume_goes_on_as_the_uninterrupted_run(data, tmp_path):
    best, log = _port(data, tmp_path / "whole.json")
    root, name = data
    out = str(tmp_path / "cut.json")
    pharness.run_port(2, out, "cpu", 43, data=root, name=name, hp=HP)
    assert Path(tmp_path / "cut_ckpt" / "last").exists()
    assert (tmp_path / "cut_live.json").exists()
    rbest, rlog = pharness.run_port(EPOCHS, out, "cpu", 43, data=root, name=name, hp=HP,
                                    resume=True)
    assert rlog == log
    timing = ("time_cost", "seconds_per_epoch", "step_ms_median")
    assert {k: v for k, v in rbest.items() if k not in timing} == \
        {k: v for k, v in best.items() if k not in timing}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        pharness.run_port(EPOCHS, str(tmp_path / "none.json"), "cpu", data=root, name=name,
                          hp=HP, resume=True)


def test_harness_runs_on_the_card_unless_asked_for_the_cpu(data, tmp_path, monkeypatch):
    root, name = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", root, "--name", name, "--epochs", "1", "--out", str(tmp_path / "a.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pharness.main(argv)
    assert not (tmp_path / "a.json").exists()
    with pytest.raises(ValueError, match="trains"):
        pharness.run_port(1, str(tmp_path / "b.json"), "cpu", data=root, name=name,
                          model="GNN", hp=HP)
    with pytest.raises(FileNotFoundError, match="no 7_0_0 dataset"):
        pharness.ensure_dataset(str(tmp_path), "7_0_0")
    assert pharness.ensure_dataset(root, name)["n_workers"] == 1


def test_dataset_is_there_only_with_its_record(tmp_path, monkeypatch):
    """Split files without ``draw_{name}.json`` are drawn anew; a generation
    that fails leaves no split file; processes started together generate
    the set once."""
    import threading
    import time

    small = dict(TINY, num_train=2, num_valid=1, num_test=1)
    root = str(tmp_path / "d")
    draw = pharness.ensure_dataset(root, "5_0_0", 1, **small)
    assert draw["n_workers"] == 1 and draw["args"]["n_isolated"] == 5
    loc = Path(root) / "loc_test_charged5_0_0.npy"
    whole = loc.read_bytes()
    splits = sorted(p.name for p in Path(root).iterdir() if not p.name.startswith(".")
                    and p.name != "draw_5_0_0.json")
    assert len(splits) == 15
    # a cut generation: a truncated file and no record
    loc.write_bytes(whole[:100])
    (Path(root) / "draw_5_0_0.json").unlink()
    again = pharness.ensure_dataset(root, "5_0_0", 1, **small)
    assert (again["n_workers"], again["args"]) == (1, draw["args"])
    assert loc.read_bytes() == whole

    real, calls = psim.generate_dataset, []

    def failing(path, **kw):
        real(path, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(psim, "generate_dataset", failing)
    empty = tmp_path / "e"
    with pytest.raises(KeyboardInterrupt):
        pharness.ensure_dataset(str(empty), "5_0_0", 1, **small)
    assert [p.name for p in empty.iterdir()] == [".draw_5_0_0.lock"]

    def slow(path, **kw):
        calls.append(path)
        time.sleep(0.5)
        return real(path, **kw)

    monkeypatch.setattr(psim, "generate_dataset", slow)
    together = str(tmp_path / "t")
    draws = [None] * 3

    def run(i):
        draws[i] = pharness.ensure_dataset(together, "5_0_0", 1, **small)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and draws[0] == draws[1] == draws[2]


def test_report_computes_the_ratio_and_the_equal_epoch_rows(tmp_path):
    def write(path, loss_test, losses, epochs):
        best = dict(epoch_index=epochs[-1], loss_valid=loss_test, loss_test=loss_test,
                    loss_train=0.1, time_cost=10.0, seconds_per_epoch=0.5,
                    step_ms_median=3.0, epochs_run=20, device="card, 700.00 W",
                    data={"stream": "serial"})
        with open(path, "w") as f:
            json.dump([best, dict(epochs=epochs, loss=losses, loss_train=[0.1] * 20)], f)

    exp = dict(title="t", name="5_0_0", model="VNEGNN", seeds=(43, 44), cap=20,
               marks=(5, 10, 15), jax=0.02, jax_note="j", ref_note="r")
    assert report.experiment_lines(exp, str(tmp_path), str(tmp_path))[-2] == \
        "*(no run of the port yet)*"
    write(report.port_path(str(tmp_path), "5_0_0", "VNEGNN", 43), 0.018, [0.03, 0.02], [5, 10])
    write(report.port_path(str(tmp_path), "5_0_0", "VNEGNN", 44), 0.026, [0.04, 0.03, 0.026],
          [5, 10, 15])
    bests = [report.load(report.port_path(str(tmp_path), "5_0_0", "VNEGNN", s))[0]
             for s in (43, 44)]
    med, ratio = report.median_ratio(bests, 0.02)
    assert med == pytest.approx(0.022) and ratio == pytest.approx(1.1)
    logs = [report.load(report.port_path(str(tmp_path), "5_0_0", "VNEGNN", s))[1]
            for s in (43, 44)]
    assert report.equal_epoch_rows(logs, (5, 15)) == [(5, [0.03, 0.04]), (15, [None, 0.026])]
    text = "\n".join(report.experiment_lines(exp, str(tmp_path), str(tmp_path)))
    assert "ratio port / JAX: **1.100**, inside the band" in text
    assert "| 15 | — | 0.026000 |" in text
    write(report.port_path(str(tmp_path), "5_0_0", "VNEGNN", 44), 0.040, [0.04], [5])
    text = "\n".join(report.experiment_lines(exp, str(tmp_path), str(tmp_path)))
    assert "ratio port / JAX: **1.450**, **outside** the band" in text
    report.main(["--dir", str(tmp_path), "--jax_dir", str(REPO / "docs" / "parity")])
    assert "0.008684" in (tmp_path / "PARITY.md").read_text()


def test_harness_and_report_import_no_jax(data, tmp_path):
    root, name = data
    code = (
        "import sys; sys.path.insert(0, 'scripts')\n"
        "import torch_parity_nbody as h, torch_parity_report\n"
        f"h.run_port(1, {str(tmp_path / 'x.json')!r}, 'cpu', data={root!r}, name={name!r}, "
        f"hp={HP!r})\n"
        f"torch_parity_report.main(['--dir', {str(tmp_path)!r}])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'fastegnn_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO), env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
