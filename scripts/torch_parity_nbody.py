#!/usr/bin/env python3
"""Converged N-body MSE parity of the PyTorch / CUDA port.

The port's side of ``scripts/parity_nbody.py``: :func:`run_port` is that
script's ``run_jax`` on ``fastegnn_tpu_torch``, with its hyperparameters
(``HP``), its datasets (``cutoff_rate`` 0.5, test split rotated from seed
43, fibonacci-sphere virtual positions for VNEGNN) and its loop arguments
(``shuffle=False``, the shared MMD draw for the Fast* family, an eval every
5 epochs, early stop after 100 without a better validation loss).  It
writes the reference's ``[best, log]`` JSON, with the run's device, wall
seconds and seconds per epoch in ``best``; ``scripts/torch_parity_report.py``
sets the JSONs beside the JAX package's numbers in ``docs/parity/``.

Usage, from the repository root (the card unless ``--platform cpu``)::

    python scripts/torch_parity_nbody.py --model FastEGNN --seed 43 --epochs 300 \\
        --out docs/parity_port/5_0_0_fastegnn_s43.json
    python scripts/torch_parity_nbody.py --data data/nbody_parity100 --name 100_0_0 \\
        --n_workers 8 --epochs 600 --out docs/parity_port/100_0_0_fastegnn_s43.json

A dataset without its record ``draw_{name}.json`` is generated first with
the port's generator and the arguments of its ``data/*/README.md``:
``5_0_0`` serially, which writes the JAX package's files bit for bit;
``100_0_0`` may take ``--n_workers``, whose per-trajectory seeds give
another draw from the same generator (the JSON's ``best["data"]`` says
which).  Runs started together share one generation (:func:`ensure_dataset`).
Beside ``--out`` the run keeps its live log (``*_live.json``, rewritten
every epoch) and the loop's checkpoint of its last epoch (``*_ckpt/last``);
``--resume`` goes on from that checkpoint as the uninterrupted run would
have.  ``scripts/torch_parity_runs.sh`` starts the eight runs of
``docs/parity_port/`` together on one card.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DATA = os.path.join(REPO, "data", "nbody_parity")
NAME = "5_0_0"
MODEL = "FastEGNN"
MODELS = ("FastEGNN", "EGNN", "VNEGNN")
HP = dict(sigma=1.5, weight=0.01, batch_size=100, lr=5e-4, wd=1e-12,
          hidden=64, channels=3, layers=4, cutoff=0.5, sample=3,
          test_interval=5, early_stop=100)
# the generator's arguments in data/nbody_parity{,100}/README.md
DATASETS = {
    "5_0_0": dict(n_isolated=5, num_train=3000, num_valid=800, num_test=800, seed=42),
    "100_0_0": dict(n_isolated=100, num_train=1000, num_valid=200, num_test=200, seed=42),
}


def fibonacci_positions(coords: np.ndarray, samples: int) -> np.ndarray:
    """[C, 3] fibonacci-sphere virtual positions (reference
    ``datasets/protein/dataset.py:176-205``): centre the coordinates' mean,
    radius the largest distance from it, golden-angle sphere."""
    center = coords.mean(axis=0, keepdims=True)
    radius = np.linalg.norm(coords - center, axis=1).max()
    phi = math.pi * (math.sqrt(5.0) - 1.0)
    pts = []
    for i in range(samples):
        y = 1 - (i / float(samples - 1)) * 2
        r = math.sqrt(1 - y * y)
        theta = phi * i
        pts.append([math.cos(theta) * r, y, math.sin(theta) * r])
    return np.asarray(pts, np.float64) * radius + center


def ensure_dataset(data: str, name: str, n_workers: int = 1, **generator_args) -> dict:
    """Generate ``data``'s split files of ``name`` unless they are there, and
    say how they were drawn: ``{"name", "n_workers", "args", "generate_s",
    "stream"}``, kept in ``data/draw_{name}.json``.  That record is written
    last, and it alone says the files are there: split files without it
    (from a generation that was cut short, or from another tool) are drawn
    anew.  The files are written into a temporary directory inside ``data``
    and moved into place before the record, under a lock on
    ``data/.draw_{name}.lock``, so processes started together on an absent
    dataset generate it once and none reads it half-written.
    ``generator_args`` replace the README's (split sizes, steps) for a
    smaller set."""
    os.makedirs(data, exist_ok=True)
    marker = os.path.join(data, f"draw_{name}.json")
    with open(os.path.join(data, f".draw_{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(marker):
            with open(marker) as f:
                return json.load(f)
        if name not in DATASETS:
            raise FileNotFoundError(f"no {name} dataset in {data}, and no generator arguments "
                                    f"for it (have: {sorted(DATASETS)})")
        from fastegnn_tpu_torch.data.nbody_sim import generate_dataset

        args = dict(DATASETS[name], **generator_args)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f".draw_{name}_", dir=data) as tmp:
            generate_dataset(tmp, **args, n_workers=n_workers)
            for fname in os.listdir(tmp):
                os.replace(os.path.join(tmp, fname), os.path.join(data, fname))
        draw = {"name": name, "n_workers": n_workers, "args": args,
                "generate_s": time.perf_counter() - t0,
                "stream": ("serial: the JAX package's files" if n_workers == 1 else
                           "worker seeds: another draw than the JAX package's serial files")}
        with open(marker + ".tmp", "w") as f:
            json.dump(draw, f)
        os.replace(marker + ".tmp", marker)
        return draw


def load_datasets(data: str, name: str, model: str, device, hp: dict = HP):
    """The train, valid and test splits the JAX harness trains on; for
    VNEGNN each graph carries its fibonacci positions ``[1, 3, C]``."""
    from fastegnn_tpu_torch.data.nbody import NBodyDataset

    sets = [NBodyDataset(data, name, partition=part, device=device,
                         virtual_channels=hp["channels"], cutoff_rate=hp["cutoff"],
                         rotation_seed=43)
            for part in ("train", "valid", "test")]
    if model == "VNEGNN":
        for ds in sets:
            for g in ds.graphs:
                # the padded coordinates, as the JAX harness's collate
                # reads them (an N-body graph has no padded node)
                fib = fibonacci_positions(np.asarray(g["coord"], np.float64), hp["channels"])
                g["virtual_fibonacci"] = fib.T[None].astype(np.float32)
    return sets


def device_line(device) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def paths(out_json: str):
    """The live log's directory and name, and the checkpoint directory, of a
    run writing ``out_json``."""
    stem = out_json[:-5] if out_json.endswith(".json") else out_json
    return (os.path.dirname(out_json) or ".", os.path.basename(stem) + "_live.json",
            stem + "_ckpt")


def draw_steps(net, opt, mmd: dict, draw_fn) -> dict:
    """The loop's ``train_step_fn`` / ``eval_step_fn`` that hand each step
    ``draw_fn(key, graph)`` as its MMD draw; none without ``draw_fn``."""
    from fastegnn_tpu_torch.train.step import make_eval_step, make_train_step

    if draw_fn is None:
        return {}
    train_step, eval_step = make_train_step(net, opt, **mmd), make_eval_step(net, **mmd)
    return dict(train_step_fn=lambda g, key: train_step(g, draw=draw_fn(key, g)),
                eval_step_fn=lambda g, key: eval_step(g, draw=draw_fn(key, g)))


def write_result(best: dict, log: dict, out_json: str, device, **facts):
    """Move the loop's telemetry into ``best`` as wall seconds, seconds per
    epoch, median step and epochs run, add the device's line and ``facts``,
    write ``[best, log]`` to ``out_json`` and return them."""
    tel = log.pop("telemetry")
    seconds = sum(t["seconds"] for t in tel)
    best.update(time_cost=seconds, seconds_per_epoch=seconds / len(tel),
                step_ms_median=statistics.median(t["step_ms_median"] for t in tel),
                epochs_run=len(tel), **facts, device=device_line(device))
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump([best, log], f, indent=2)
    print("PORT BEST:", json.dumps(best), flush=True)
    return best, log


def run_port(epochs: int, out_json: str, platform=None, seed: int = 43, *,
             data: str = DATA, name: str = NAME, model: str = MODEL, hp: dict = HP,
             n_workers: int = 1, state_dict=None, resume: bool = False):
    """Train ``model`` to early stop or ``epochs`` and write ``[best, log]``
    to ``out_json``; returns them.  ``state_dict``: initial weights in place
    of the seeded init; ``resume``: go on from the run's last checkpoint."""
    import torch

    from fastegnn_tpu_torch.cli.common import training_device
    from fastegnn_tpu_torch.models import MMD_MODELS, get_model
    from fastegnn_tpu_torch.train.loop import train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.utils.seed import fix_seed

    if model not in MODELS:
        raise ValueError(f"--model {model!r}: the harness trains {MODELS}")
    device = training_device(platform)
    draw = ensure_dataset(data, name, n_workers)
    dtr, dva, dte = load_datasets(data, name, model, device, hp)
    net = get_model(model, dtr.spec.node_feat_dim, dtr.spec.edge_attr_dim, hidden=hp["hidden"],
                    virtual_channels=hp["channels"], n_layers=hp["layers"],
                    compute_dtype=torch.float32, device=device, generator=fix_seed(seed))
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    opt = torch_adam(net.parameters(), hp["lr"], hp["wd"])
    log_dir, log_name, ckpt_dir = paths(out_json)
    last = os.path.join(ckpt_dir, "last")
    if resume and not os.path.exists(last):
        raise FileNotFoundError(f"--resume: no checkpoint {last}")
    best, log, _ = train(
        net, opt, dtr, dva, dte, batch_size=hp["batch_size"], sigma=hp["sigma"],
        weight=hp["weight"], sample=hp["sample"], per_graph_sampling=False,
        use_mmd=model in MMD_MODELS, test_interval=hp["test_interval"],
        early_stop=hp["early_stop"], max_epochs=epochs, seed=seed, shuffle=False,
        log_directory=log_dir, log_name=log_name, ckpt_directory=ckpt_dir,
        resume_from=last if resume else None, verbose=True)
    return write_result(best, log, out_json, device, max_epochs=epochs, model=model, seed=seed,
                        data=draw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--out", type=str, default=None,
                   help="the [best, log] JSON (default logs/parity_port/<name>_<model>_s<seed>.json)")
    p.add_argument("--platform", type=str, default=None,
                   help="the device: absent for the CUDA card, 'cpu' for the CPU")
    p.add_argument("--data", type=str, default=DATA)
    p.add_argument("--name", type=str, default=NAME)
    p.add_argument("--model", type=str, default=MODEL, choices=MODELS)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--n_workers", type=int, default=1,
                   help="generator processes when the dataset is absent (> 1: another draw)")
    p.add_argument("--resume", action="store_true",
                   help="go on from the last checkpoint beside --out")
    a = p.parse_args(argv)
    out = a.out or os.path.join(REPO, "logs", "parity_port",
                                f"{a.name}_{a.model.lower()}_s{a.seed}.json")
    run_port(a.epochs, out, a.platform, a.seed, data=a.data, name=a.name, model=a.model,
             n_workers=a.n_workers, resume=a.resume)


if __name__ == "__main__":
    main()
