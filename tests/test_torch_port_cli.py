"""The port's Water-3D CLI (``python -m fastegnn_tpu_torch.cli.simulation``)
through its argparse wiring, on the CPU, for a couple of epochs on a tiny
synthetic h5 trio (as ``tests/test_cli.py`` runs the JAX CLI)."""

import json

import numpy as np
import pytest
import torch

from fastegnn_tpu.cli import simulation as jcli
from fastegnn_tpu_torch.cli import simulation as pcli
from fastegnn_tpu_torch.data.simulation import make_synthetic_simulation_h5

ARGS = ["--virtual_channel", "3", "--batch_size", "2", "--max_epochs", "2",
        "--test_interval", "1", "--max_train_samples", "4", "--max_test_samples", "2",
        "--radius", "0.15"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_synthetic_simulation_h5(str(root / "Water-3D"), n_trajectories=1, n_particles=40,
                                 n_frames=40)
    return str(root)


def _logs(directory):
    logs = list(directory.glob("*_loss_*.json"))
    assert len(logs) == 1, "JSON log missing"
    best, log = json.loads(logs[0].read_text())
    return best, log


@pytest.mark.parametrize("variant", [[], ["--attention_required"]])
def test_cli_trains_on_the_cpu(data, tmp_path, variant):
    best = pcli.main(["--data_directory", data, *ARGS, "--platform", "cpu",
                      "--log_directory", str(tmp_path / "logs"),
                      "--profile_trace", str(tmp_path / "trace"),
                      "--ckpt_directory", str(tmp_path / "ck"), *variant])
    assert np.isfinite(best["loss_valid"])
    # the reference's JSON log, [best, log]
    logged_best, log = _logs(tmp_path / "logs")
    assert log["epochs"] == [1, 2] and len(log["loss_train"]) == 2
    assert logged_best["epoch_index"] == best["epoch_index"]
    assert np.isfinite(log["loss"]).all()
    # the second epoch's profiler trace and the best checkpoint
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert (tmp_path / "ck" / "best").is_file()


def test_cli_resumes_from_its_checkpoint(data, tmp_path):
    common = ["--data_directory", data, *ARGS, "--platform", "cpu",
              "--ckpt_directory", str(tmp_path / "ck")]
    pcli.main(common + ["--max_epochs", "1", "--log_directory", str(tmp_path / "a")])
    best = pcli.main(common + ["--resume", str(tmp_path / "ck" / "best"),
                               "--log_directory", str(tmp_path / "b")])
    _, log = _logs(tmp_path / "b")
    assert log["epochs"] == [2] and np.isfinite(best["loss_valid"])


def test_cli_needs_a_card_unless_the_cpu_is_asked_for(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcli.main(["--data_directory", data, *ARGS])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["--data_directory", data, *ARGS, "--platform", "cuda"])


@pytest.mark.parametrize("flags,match", [(["--model", "EGNN"], "items 11-12"),
                                         (["--mesh", "data=2"], "item 13"),
                                         (["--mesh", "data=1,graph=2"], "item 13")])
def test_cli_raises_on_what_the_port_does_not_have(data, flags, match):
    with pytest.raises(ValueError, match=match):
        pcli.main(["--data_directory", data, *ARGS, "--platform", "cpu", *flags])


def test_parser_has_the_jax_flags_and_defaults():
    def flags(parser):
        return {a.dest: (a.default, a.required, tuple(a.option_strings))
                for a in parser._actions if a.dest != "help"}

    port, jax_flags = flags(pcli.build_parser()), flags(jcli.build_parser())
    # the JAX default None means bfloat16 under a graph mesh on a TPU and
    # float32 otherwise (fastegnn_tpu/cli/common.py:86-96); the port has
    # only the latter
    assert port.pop("compute_dtype")[0] == "float32"
    assert jax_flags.pop("compute_dtype")[0] is None
    assert port == jax_flags
