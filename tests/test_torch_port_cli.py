"""The port's CLIs through their argparse wiring, on the CPU, for a couple
of epochs on tiny synthetic data (as ``tests/test_cli.py`` runs the JAX
CLIs): Water-3D (``python -m fastegnn_tpu_torch.cli.simulation``) on an h5
trio, N-body on the port's generator's files, protein on a synthetic npz,
and the equivariance check; each parser against the JAX CLI's."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastegnn_tpu.cli import equivariance as jeq
from fastegnn_tpu.cli import generate_nbody as jgen
from fastegnn_tpu.cli import nbody as jnbody
from fastegnn_tpu.cli import protein as jprotein
from fastegnn_tpu.cli import simulation as jcli
from fastegnn_tpu_torch.cli import equivariance as peq
from fastegnn_tpu_torch.cli import generate_nbody as pgen
from fastegnn_tpu_torch.cli import nbody as pnbody
from fastegnn_tpu_torch.cli import protein as pprotein
from fastegnn_tpu_torch.cli import simulation as pcli
from fastegnn_tpu_torch.data.protein import make_synthetic_protein_npz
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


# the ids of the cases as they were before the bf16 case left this test
@pytest.mark.parametrize("flags,match", [
    pytest.param(["--mesh", "data=2"], "torchrun", id="flags1-torchrun"),
    pytest.param(["--mesh", "graph=2"], "torchrun --standalone --nproc_per_node 2",
                 id="flags2-torchrun --standalone --nproc_per_node 2"),
    pytest.param(["--model", "EGHN", "--mesh", "data=2"], "custom step",
                 id="flags3-custom step"),
    pytest.param(["--model", "MLP"], "not a graph batch", id="flags4-not a graph batch"),
    pytest.param(["--model", "EGHN"], "local bond edges", id="flags5-local bond edges")])
def test_cli_raises_on_what_the_port_does_not_have(data, flags, match):
    with pytest.raises(ValueError, match=match):
        pcli.main(["--data_directory", data, *ARGS, "--platform", "cpu", *flags])


def _built_models(monkeypatch, train=True):
    """The models the CLIs build from here on, in a list; with ``train``
    False the training loop is stubbed out."""
    from fastegnn_tpu_torch import models
    from fastegnn_tpu_torch.train import loop

    built = []
    build = models.get_model
    monkeypatch.setattr(models, "get_model", lambda *a, **k: built.append(build(*a, **k))
                        or built[-1])
    if not train:
        monkeypatch.setattr(loop, "train", lambda *a, **k: ({"loss_valid": 0.0}, {}, 0))
    return built


def _check_float32(built, model, out):
    """One model built, all in float32, and the CLI's line that says so."""
    assert len(built) == 1 and all(p.dtype == torch.float32 for p in built[0].parameters())
    assert f"{model} has no bfloat16 path and computes in float32" in out


def test_cli_trains_in_float32_where_the_model_has_no_bf16_path(data, tmp_path, monkeypatch,
                                                                 capsys):
    # as the JAX CLI, whose get_model drops --compute_dtype for TFN
    built = _built_models(monkeypatch)
    best = pcli.main(["--data_directory", data, *ARGS, "--platform", "cpu", "--model", "TFN",
                      "--compute_dtype", "bfloat16", "--max_epochs", "1", "--num_layer", "1",
                      "--log_directory", str(tmp_path)])
    assert np.isfinite(best["loss_valid"])
    _check_float32(built, "TFN", capsys.readouterr().out)


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


# --- the N-body, protein, generator and equivariance CLIs ------------------

TRAIN = ["--virtual_channel", "3", "--batch_size", "2", "--num_layer", "2",
         "--max_epochs", "2", "--test_interval", "1"]


@pytest.fixture(scope="module")
def nbody_data(tmp_path_factory):
    """5 particles, 4 train and 2 + 2 eval trajectories of 41 samples, from
    the port's generator CLI."""
    root = tmp_path_factory.mktemp("nbody")
    name = pgen.main(["--path", str(root), "--n_isolated", "5", "--num-train", "4",
                      "--num-valid", "2", "--num-test", "2", "--length", "410",
                      "--sample-freq", "10", "--seed", "0"])
    assert name == "5_0_0"
    return ["--data_directory", str(root), "--dataset_name", name]


@pytest.fixture(scope="module")
def protein_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("protein") / "adk.npz"
    make_synthetic_protein_npz(str(path), n_atoms=40, n_frames=60)
    return ["--npz", str(path), "--delta_frame", "5", "--max_train_samples", "4",
            "--max_test_samples", "2"]


@pytest.mark.parametrize("cli", ["nbody", "protein"])
def test_nbody_and_protein_clis_train_on_the_cpu(nbody_data, protein_npz, tmp_path, cli):
    mod, data = (pnbody, nbody_data) if cli == "nbody" else (pprotein, protein_npz)
    best = mod.main([*data, *TRAIN, "--platform", "cpu", "--log_directory",
                     str(tmp_path / "logs"), "--ckpt_directory", str(tmp_path / "ck")])
    assert np.isfinite(best["loss_valid"]) and best["epoch_index"] in (1, 2)
    logged_best, log = _logs(tmp_path / "logs")
    assert log["epochs"] == [1, 2] and np.isfinite(log["loss_train"] + log["loss"]).all()
    assert logged_best["epoch_index"] == best["epoch_index"]
    assert (tmp_path / "ck" / "best").is_file()


@pytest.mark.parametrize("model", ["FastRF", "FastSchNet", "FastTFN", "VNEGNN"])
@pytest.mark.parametrize("cli", ["nbody", "protein"])
def test_nbody_and_protein_clis_train_the_new_models_on_the_cpu(nbody_data, protein_npz,
                                                                tmp_path, cli, model,
                                                                monkeypatch):
    # the MMD term where the JAX CLI adds it (MMD_MODELS): not for VNEGNN
    from fastegnn_tpu_torch.train import step as pstep

    mmd_calls = []
    mmd = pstep.mmd_loss
    monkeypatch.setattr(pstep, "mmd_loss", lambda *a, **k: mmd_calls.append(1) or mmd(*a, **k))
    mod, data = (pnbody, nbody_data) if cli == "nbody" else (pprotein, protein_npz)
    best = mod.main([*data, *TRAIN, "--model", model, "--platform", "cpu",
                     "--log_directory", str(tmp_path / "logs")])
    assert np.isfinite(best["loss_valid"]) and best["epoch_index"] in (1, 2)
    _, log = _logs(tmp_path / "logs")
    assert log["epochs"] == [1, 2] and np.isfinite(log["loss_train"] + log["loss"]).all()
    assert bool(mmd_calls) == (model != "VNEGNN")


@pytest.mark.parametrize("cli,model", [("nbody", "EGNN"), ("nbody", "GNN"), ("nbody", "RF"),
                                       ("nbody", "Linear"), ("nbody", "SchNet"),
                                       ("protein", "EGNN"), ("protein", "EGHN")])
def test_nbody_and_protein_clis_train_the_baselines_on_the_cpu(nbody_data, protein_npz,
                                                               tmp_path, cli, model,
                                                               monkeypatch):
    # on the MSE alone, as in the JAX CLI; the protein CLI hands EGHN the bonds
    from fastegnn_tpu_torch.train import step as pstep

    mmd_calls = []
    monkeypatch.setattr(pstep, "mmd_loss", lambda *a, **k: mmd_calls.append(1))
    mod, data = (pnbody, nbody_data) if cli == "nbody" else (pprotein, protein_npz)
    best = mod.main([*data, *TRAIN, "--model", model, "--platform", "cpu",
                     "--log_directory", str(tmp_path / "logs")])
    assert np.isfinite(best["loss_valid"]) and best["epoch_index"] in (1, 2)
    _, log = _logs(tmp_path / "logs")
    assert log["epochs"] == [1, 2] and np.isfinite(log["loss_train"] + log["loss"]).all()
    assert not mmd_calls


@pytest.mark.parametrize("cli,model", [("nbody", "GVP"), ("nbody", "DimeNet"),
                                       ("protein", "DimeNet")])
def test_nbody_and_protein_clis_train_gvp_and_dimenet_on_the_cpu(nbody_data, protein_npz,
                                                                 tmp_path, cli, model,
                                                                 monkeypatch):
    # on the MSE alone; DimeNet's splits carry their triplet tables, built
    # once per batch: 2 train batches per epoch (shuffled, so collated
    # afresh) and the eval batches once (the collate cache keeps them)
    from fastegnn_tpu_torch.graph import build_triplets
    from fastegnn_tpu_torch.models import dimenet as pdn
    from fastegnn_tpu_torch.train import step as pstep

    mmd_calls, builds = [], []
    monkeypatch.setattr(pstep, "mmd_loss", lambda *a, **k: mmd_calls.append(1))
    monkeypatch.setattr(pdn, "build_triplets", lambda g: builds.append(1) or build_triplets(g))
    mod, data = (pnbody, nbody_data) if cli == "nbody" else (pprotein, protein_npz)
    best = mod.main([*data, *TRAIN, "--model", model, "--platform", "cpu",
                     "--log_directory", str(tmp_path / "logs")])
    assert np.isfinite(best["loss_valid"]) and best["epoch_index"] in (1, 2)
    _, log = _logs(tmp_path / "logs")
    assert log["epochs"] == [1, 2] and np.isfinite(log["loss_train"] + log["loss"]).all()
    assert not mmd_calls
    assert len(builds) == (2 * 2 + 1 + 1 if model.startswith("DimeNet") else 0)


@pytest.mark.parametrize("model", ["GVP", "DimeNet", "DimeNet++"])
def test_new_models_refuse_bfloat16(nbody_data, model, monkeypatch, capsys, tmp_path):
    # built in float32 with the CLI's line, as the JAX CLI builds them
    # (the training loop stubbed out)
    built = _built_models(monkeypatch, train=False)
    pnbody.main([*nbody_data, *TRAIN, "--model", model, "--platform", "cpu",
                 "--compute_dtype", "bfloat16", "--log_directory", str(tmp_path)])
    _check_float32(built, model, capsys.readouterr().out)


@pytest.mark.parametrize("model,match", [("MLP", "not a graph batch"),
                                         ("EGHN", "local bond edges")])
def test_nbody_cli_raises_for_mlp_and_for_eghn(nbody_data, model, match):
    with pytest.raises(ValueError, match=match):
        pnbody.main([*nbody_data, *TRAIN, "--model", model, "--platform", "cpu"])


@pytest.mark.parametrize("cli", ["nbody", "protein"])
def test_nbody_and_protein_clis_need_a_card_unless_the_cpu_is_asked_for(
        nbody_data, protein_npz, monkeypatch, cli):
    mod, data = (pnbody, nbody_data) if cli == "nbody" else (pprotein, protein_npz)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([*data, *TRAIN])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([*data, *TRAIN, "--platform", "cuda"])


def test_protein_cli_raises_on_what_the_port_does_not_have(protein_npz, monkeypatch, capsys,
                                                           tmp_path):
    # --compute_dtype bfloat16 with TFN trains in float32 (the training
    # loop stubbed out here), as the JAX CLI does
    with monkeypatch.context() as m:
        built = _built_models(m, train=False)
        pprotein.main([*protein_npz, *TRAIN, "--platform", "cpu", "--model", "TFN",
                       "--compute_dtype", "bfloat16", "--log_directory", str(tmp_path)])
        _check_float32(built, "TFN", capsys.readouterr().out)
    with pytest.raises(ValueError, match="not a graph batch"):
        pprotein.main([*protein_npz, *TRAIN, "--platform", "cpu", "--model", "MLP"])
    monkeypatch.setitem(sys.modules, "MDAnalysis", None)
    with pytest.raises(ImportError, match="MDAnalysis"):
        pprotein.main([*protein_npz, "--virtual_channel", "3", "--preprocess"])


def test_equivariance_cli_passes_at_its_tolerance_and_fails_at_zero(capsys, monkeypatch):
    small = ["--nodes", "8", "--num_layer", "2", "--trials", "2", "--platform", "cpu"]
    errs = peq.errors(peq.build_parser().parse_args(small))
    assert len(errs) == 2 and max(errs) <= 1e-4 and min(errs) > 0
    assert peq.main(small) == 0
    out = capsys.readouterr().out
    assert out.count("PASS\n") == 2 and "PASSED" in out
    assert peq.main(small + ["--atol", "0"]) == 1
    assert "FAILED" in capsys.readouterr().out
    # the CLIs' TFN (nf = 32) is equivariant too
    assert peq.main(small + ["--model", "TFN"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peq.main(["--nodes", "8"])


@pytest.mark.parametrize("model", ["FastRF", "FastSchNet", "FastTFN", "VNEGNN", "EGNN", "RF",
                                   "Linear", "SchNet"])
def test_equivariance_cli_checks_the_new_models(model, capsys):
    small = ["--nodes", "8", "--num_layer", "2", "--trials", "2", "--platform", "cpu",
             "--model", model]
    errs = peq.errors(peq.build_parser().parse_args(small))
    assert len(errs) == 2 and max(errs) <= 1e-4 and min(errs) > 0
    assert peq.main(small) == 0 and capsys.readouterr().out.count("PASS\n") == 2


def test_equivariance_cli_fails_gvp_and_refuses_dimenet(capsys):
    # GVP reads absolute positions: rotation-equivariant, not translation;
    # DimeNet needs triplets, which the check's graph does not carry (the
    # JAX CLI fails on it too)
    small = ["--nodes", "8", "--num_layer", "2", "--trials", "2", "--platform", "cpu"]
    assert peq.main(small + ["--model", "GVP"]) == 1
    assert capsys.readouterr().out.count("FAIL\n") == 2
    for model in ("DimeNet", "DimeNet++"):
        with pytest.raises(ValueError, match="triplet table"):
            peq.main(small + ["--model", model])


def test_equivariance_cli_takes_a_tensor_output_whole(capsys, monkeypatch):
    # RF returns its positions as a tensor: the check reads all of them (not
    # the first node's row) and passes; GNN is not equivariant and fails
    import fastegnn_tpu_torch.models as pmodels

    small = ["--nodes", "8", "--num_layer", "2", "--trials", "2", "--platform", "cpu"]
    assert peq.main(small + ["--model", "RF"]) == 0
    assert capsys.readouterr().out.count("PASS\n") == 2
    errs = peq.errors(peq.build_parser().parse_args(small + ["--model", "GNN"]))
    assert min(errs) > 1e-2
    assert peq.main(small + ["--model", "GNN"]) == 1
    assert "FAILED" in capsys.readouterr().out

    # RF with every row but the first knocked out of equivariance fails:
    # every row is read
    class FirstRowOnly(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, g):
            x = self.inner(g)
            return torch.cat([x[:1], x[1:] + g.coord[1:].square()], 0)

    build = pmodels.get_model
    monkeypatch.setattr(pmodels, "get_model", lambda *a, **k: FirstRowOnly(build(*a, **k)))
    assert peq.main(small + ["--model", "RF"]) == 1


def test_equivariance_cli_moves_the_jax_clis_graphs(monkeypatch, capsys):
    """Every batch the port's check hands its model, the graph and each
    trial's rotated and translated copy (``loc_mean`` included), is the one
    the JAX CLI hands its model for the same seed."""
    import fastegnn_tpu.models as jmodels
    from fastegnn_tpu_torch.models.fast_egnn import FastEGNN

    seen_j, seen_p = [], []
    make = jmodels.get_model

    class _Seen:
        def __init__(self, model):
            self.model = model

        def init(self, key, g):
            return self.model.init(key, g)

        def apply(self, variables, g):
            seen_j.append(g)
            return self.model.apply(variables, g)

    forward = FastEGNN.forward

    def seen_forward(self, g, *args, **kwargs):
        seen_p.append(g)
        return forward(self, g, *args, **kwargs)

    monkeypatch.setattr(jmodels, "get_model", lambda *a, **k: _Seen(make(*a, **k)))
    monkeypatch.setattr(FastEGNN, "forward", seen_forward)
    argv = ["--nodes", "7", "--num_layer", "1", "--trials", "2", "--seed", "4",
            "--platform", "cpu"]
    assert jeq.main(argv) == 0 and peq.main(argv) == 0
    capsys.readouterr()
    assert len(seen_j) == len(seen_p) == 4   # per trial: the moved graph, then the graph
    fields = ("node_feat", "coord", "vel", "coord_target", "edge_attr", "dst", "src",
              "node_mask", "edge_mask", "loc_mean", "node_attr")
    for i, (a, b) in enumerate(zip(seen_j, seen_p)):
        for f in fields:
            want, got = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert want.shape == got.shape, (i, f)
            if i % 2:   # the unmoved graph: the same arrays exactly
                np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=f)
            else:       # a 3x3 product and a sum in f32 by two libraries
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f)
    assert np.abs(np.asarray(seen_j[0].loc_mean) - np.asarray(seen_j[1].loc_mean)).max() > 0.1


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(main, monkeypatch):
    """The parser a CLI's ``main`` builds, caught at its ``parse_args``."""
    def catch(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as got:
            main([])
    return got.value.parser


def _flags(parser):
    return {a.dest: (a.default, a.required, tuple(a.option_strings), a.type, a.choices)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("cli", ["nbody", "protein", "generate_nbody", "equivariance"])
def test_new_parsers_have_the_jax_flags_and_defaults(cli, monkeypatch):
    port, ref = {"nbody": (pnbody, jnbody), "protein": (pprotein, jprotein),
                 "generate_nbody": (pgen, jgen), "equivariance": (peq, jeq)}[cli]
    if cli in ("nbody", "protein"):
        p, j = _flags(port.build_parser()), _flags(ref.build_parser())
        # the JAX default None means bfloat16 under a graph mesh on a TPU and
        # float32 otherwise (fastegnn_tpu/cli/common.py:86-96); the port has
        # only the latter
        assert p.pop("compute_dtype")[0] == "float32"
        assert j.pop("compute_dtype")[0] is None
    else:
        p, j = _flags(port.build_parser()), _flags(_parser_of(ref.main, monkeypatch))
    assert p == j


def test_the_new_cli_modules_import_without_jax():
    repo = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import fastegnn_tpu_torch.cli.nbody, fastegnn_tpu_torch.cli.protein\n"
            "import fastegnn_tpu_torch.cli.generate_nbody, fastegnn_tpu_torch.cli.equivariance\n"
            "import fastegnn_tpu_torch.data.nbody, fastegnn_tpu_torch.data.protein\n"
            "import fastegnn_tpu_torch.models.tfn, fastegnn_tpu_torch.models.vnegnn\n"
            "import fastegnn_tpu_torch.models.basic, fastegnn_tpu_torch.models.eghn\n"
            "import fastegnn_tpu_torch.models.gvp, fastegnn_tpu_torch.models.dimenet\n"
            "import fastegnn_tpu_torch.native\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fastegnn_tpu.'))"
            " or m == 'fastegnn_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(repo))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
