#!/usr/bin/env python3
"""Converged Water-3D MSE parity of the PyTorch / CUDA port, matched protocol.

The port's side of ``scripts/parity_simulation.py --side jax --matched``:
:func:`run_port` is that script's ``run_jax`` on ``fastegnn_tpu_torch``,
with its hyperparameters (``HP``: batch 10, sigma 1.0, weight 0.01, H 64,
C 3, L 4, cutoff 0.0, MMD sample 3, ``delta_t`` 20, an eval every 5
epochs, no early stop), FastEGNN with gravity ``(0, -1, 0)`` in f32, the
per-graph MMD draw, and ``shuffle=False``.  Its splits are the JAX
script's synthetic trio (``synthetic_trajectories(4, 200, 300, seed=7)``,
held in memory, so no h5 file is read or written) replayed through one
recorded sampling protocol: the frames of each trajectory, the test
rotations and the sample order, drawn as the JAX script's
``ensure_protocol`` draws them (:func:`draw_protocol`) and committed as
``docs/parity_port/water3d_protocol.json``.  It writes the reference's
``[best, log]`` JSON, with the run's device, wall seconds and seconds per
epoch in ``best``; ``scripts/torch_parity_report.py`` sets the JSONs of
seeds 43-47 beside the JAX script's.

Usage, from the repository root (the card unless ``--platform cpu``)::

    python scripts/torch_parity_simulation.py --seed 43 --epochs 700 \\
        --out docs/parity_port/water3d_fastegnn_s43.json

Beside ``--out`` the run keeps its live log (``*_live.json``) and the
loop's checkpoint of its last epoch (``*_ckpt/last``); ``--resume`` goes
on from that checkpoint as the uninterrupted run would have.  ``--init
docs/parity_port/water3d_jax_init_s43.npz`` starts from the weights the
JAX harness's seed 43 starts from (:func:`load_jax_init`) in place of the
port's seeded init; the seed still sets the MMD draws.
``scripts/torch_parity_water3d_runs.sh`` starts the five seeds together on
one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from torch_parity_nbody import draw_steps, paths, write_result  # noqa: E402

PROTOCOL_PATH = os.path.join(REPO, "docs", "parity_port", "water3d_protocol.json")
# scripts/parity_simulation.py's HP and GRAVITY, with --matched's early stop
HP = dict(sigma=1.0, weight=0.01, batch_size=10, lr=5e-4, wd=1e-12,
          hidden=64, channels=3, layers=4, cutoff=0.0, sample=3,
          delta_t=20, test_interval=5, early_stop=10**9,
          n_particles=200, n_traj=4, n_frames=300)
GRAVITY = (0.0, -1.0, 0.0)
DATA_SEED = 7          # the JAX script's make_synthetic_simulation_h5 seed
PROTOCOL_SEED = 20260820


def draw_protocol(keys: dict) -> dict:
    """The JAX script's ``ensure_protocol`` draw over ``{split: [trajectory
    key, ...]}``: per trajectory 15 frames in [0, 250], per sample a test
    rotation in whole degrees, and the permutation that replaces the
    post-processing shuffle."""
    rng = np.random.default_rng(PROTOCOL_SEED)
    proto = {}
    for part in ("train", "valid", "test"):
        frames = {k: [int(v) for v in rng.integers(0, 251, size=15)] for k in keys[part]}
        n = sum(len(v) for v in frames.values())
        proto[part] = dict(
            keys=list(keys[part]), frames=frames,
            rot_deg=[int(v) for v in rng.integers(0, 361, size=n)],
            order=[int(v) for v in rng.permutation(n)],
        )
    return proto


def trajectories(hp: dict = HP) -> dict:
    """``{split: [trajectory, ...]}`` of the JAX script's synthetic trio, in
    the order its h5 files list them (h5py lists keys by name, which is
    ``traj_0`` ... ``traj_{n-1}`` for n up to 10)."""
    from fastegnn_tpu_torch.data.simulation import synthetic_trajectories

    return synthetic_trajectories(hp["n_traj"], hp["n_particles"], hp["n_frames"],
                                  seed=DATA_SEED)


def ensure_protocol(path: str, trajs: dict) -> dict:
    """The protocol in ``path``; drawn over ``trajs``' keys and written there
    (as the JAX script writes it, ``json.dump`` with its defaults) when the
    file is absent."""
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    proto = draw_protocol({s: [k for k, _, _ in t] for s, t in trajs.items()})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(proto, f)
    os.replace(path + ".tmp", path)
    return proto


def load_datasets(device, hp: dict = HP, protocol_path: str = PROTOCOL_PATH):
    """The train, valid and test splits the JAX harness trains on under
    ``--matched`` (whose dataset seeds a protocol leaves undrawn), and the
    protocol's sha256 prefix."""
    from fastegnn_tpu_torch.data.simulation import SimulationDataset

    trajs = trajectories(hp)
    proto = ensure_protocol(protocol_path, trajs)
    sets = [SimulationDataset.from_trajectories(
        trajs[part], partition=part, device=device, protocol=proto[part],
        virtual_channels=hp["channels"], cutoff_rate=hp["cutoff"], delta_t=hp["delta_t"])
        for part in ("train", "valid", "test")]
    return sets, hashlib.sha256(json.dumps(proto).encode()).hexdigest()[:16]


def load_jax_init(path: str) -> dict:
    """The port's ``state_dict`` of a JAX FastEGNN param tree saved flat in
    an ``.npz`` (one array per ``/``-joined key path)."""
    from fastegnn_tpu_torch.utils.weights import state_dict_from_jax_params

    tree = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = flat[key]
    return state_dict_from_jax_params(tree)


def run_port(epochs: int, out_json: str, platform=None, seed: int = 43, *, hp: dict = HP,
             protocol_path: str = PROTOCOL_PATH, state_dict=None, draw_fn=None,
             resume: bool = False):
    """Train FastEGNN for ``epochs`` and write ``[best, log]`` to
    ``out_json``; returns them.  ``state_dict``: initial weights in place of
    the seeded init; ``draw_fn(key, graph)``: each step's MMD draw in place
    of the one the step makes from its key; ``resume``: go on from the
    run's last checkpoint."""
    import torch

    from fastegnn_tpu_torch.cli.common import training_device
    from fastegnn_tpu_torch.models import get_model
    from fastegnn_tpu_torch.train.loop import train
    from fastegnn_tpu_torch.train.optim import torch_adam
    from fastegnn_tpu_torch.utils.seed import fix_seed

    device = training_device(platform)
    (dtr, dva, dte), proto_sha = load_datasets(device, hp, protocol_path)
    net = get_model("FastEGNN", dtr.spec.node_feat_dim, dtr.spec.edge_attr_dim,
                    hidden=hp["hidden"], virtual_channels=hp["channels"],
                    n_layers=hp["layers"], gravity=GRAVITY, compute_dtype=torch.float32,
                    device=device, generator=fix_seed(seed))
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    opt = torch_adam(net.parameters(), hp["lr"], hp["wd"])
    mmd = dict(sigma=hp["sigma"], weight=hp["weight"], sample=hp["sample"],
               per_graph_sampling=True)
    log_dir, log_name, ckpt_dir = paths(out_json)
    last = os.path.join(ckpt_dir, "last")
    if resume and not os.path.exists(last):
        raise FileNotFoundError(f"--resume: no checkpoint {last}")
    best, log, _ = train(
        net, opt, dtr, dva, dte, batch_size=hp["batch_size"], **mmd,
        test_interval=hp["test_interval"], early_stop=hp["early_stop"], max_epochs=epochs,
        seed=seed, shuffle=False, log_directory=log_dir, log_name=log_name,
        ckpt_directory=ckpt_dir, resume_from=last if resume else None, verbose=True,
        **draw_steps(net, opt, mmd, draw_fn))
    return write_result(best, log, out_json, device, max_epochs=epochs, model="FastEGNN",
                        seed=seed, protocol_sha256=proto_sha)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=700)
    p.add_argument("--out", type=str, default=None,
                   help="the [best, log] JSON (default logs/parity_port/water3d_fastegnn_s<seed>.json)")
    p.add_argument("--platform", type=str, default=None,
                   help="the device: absent for the CUDA card, 'cpu' for the CPU")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--resume", action="store_true",
                   help="go on from the last checkpoint beside --out")
    p.add_argument("--init", type=str, default=None,
                   help="start from this JAX init (.npz, see load_jax_init) in place of the "
                        "seeded one")
    a = p.parse_args(argv)
    out = a.out or os.path.join(REPO, "logs", "parity_port", f"water3d_fastegnn_s{a.seed}.json")
    run_port(a.epochs, out, a.platform, a.seed, resume=a.resume,
             state_dict=None if a.init is None else load_jax_init(a.init))


if __name__ == "__main__":
    main()
