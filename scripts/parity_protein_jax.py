"""The JAX side of the protein converged-parity run, at any seed.

``scripts/parity_protein.py --side jax`` trains the JAX package's FastEGNN
on the synthetic AdK chain with seed 43 written into its init key and its
loop's seed.  This script runs the same body with ``--seed S`` in both
places; the dataset seeds stay 43 / 44 / 45 for every ``S``, so every run
sees the same test rotations and translations.  At ``S = 43`` it is
``parity_protein.py --side jax`` exactly.  ``HP``, ``NPZ`` and
``ensure_data`` are that script's own, imported from it.

It runs on this repository's JAX package, on the CPU:

  PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/parity_protein_jax.py \\
      --seed 44 --epochs 150 --out docs/parity_port/protein_jax_s44.json
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _parity_protein():
    """``scripts/parity_protein.py`` as a module, loaded once."""
    name = "parity_protein"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(_HERE, "parity_protein.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


pp = _parity_protein()


def run_jax(epochs: int, out_json: str, platform=None, seed: int = 43):
    """``parity_protein.py::run_jax`` with ``seed`` as the init key and the
    loop's seed."""
    import jax

    if platform:
        jax.config.update("jax_platform_name", platform)
    from fastegnn_tpu.data.protein import ProteinDataset
    from fastegnn_tpu.models import FastEGNN
    from fastegnn_tpu.train import TrainState, torch_adam, train

    HP = pp.HP
    pp.ensure_data()
    mk = lambda part, ds_seed: ProteinDataset(
        pp.NPZ, partition=part, virtual_channels=HP["channels"],
        cutoff_rate=HP["cutoff"], delta_frame=HP["delta_frame"],
        contact_cutoff=HP["contact_cutoff"], test_rot=True, test_trans=True,
        seed=ds_seed)
    dtr, dva, dte = mk("train", 43), mk("valid", 44), mk("test", 45)
    model = FastEGNN(hidden=HP["hidden"], virtual_channels=HP["channels"],
                     n_layers=HP["layers"])
    example = dtr.collate(list(range(HP["batch_size"])))
    params = jax.jit(model.init)(jax.random.key(seed), example)["params"]
    tx = torch_adam(HP["lr"], HP["wd"])
    state = TrainState.create(params, tx)
    best, log, state = train(
        model, state, tx, dtr, dva, dte, batch_size=HP["batch_size"],
        sigma=HP["sigma"], weight=HP["weight"], sample=HP["sample"],
        per_graph_sampling=False, test_interval=HP["test_interval"],
        early_stop=HP["early_stop"], max_epochs=epochs, seed=seed,
        shuffle=False, log_directory=os.path.dirname(out_json) or ".",
        log_name=os.path.basename(out_json).replace(".json", "_live.json"),
        verbose=True,
    )
    with open(out_json, "w") as f:
        json.dump([best, log], f, indent=2)
    print("JAX BEST:", json.dumps(best))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--platform", type=str, default="cpu")
    a = p.parse_args()
    out = a.out or f"docs/parity_port/protein_jax_s{a.seed}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    run_jax(a.epochs, out, a.platform, a.seed)
