#!/usr/bin/env python3
"""Write ``docs/parity_port/PARITY.md`` from the port's converged-parity runs.

The port's side of ``scripts/parity_report.py``.  For each experiment it
reads the ``[best, log]`` JSONs that ``scripts/torch_parity_nbody.py``
wrote (``{dir}/{name}_{model}_s{seed}.json``, the model's name in lower
case) and sets them beside the JAX package's result: its JSON in
``docs/parity/`` where there is one, else the numbers ``docs/parity/
PARITY.md`` records (round 5).  Per experiment: each seed's best test MSE
with its epoch, early stop and wall seconds; the median over seeds and its
ratio to the JAX number against the band fixed before the runs
(``BAND``); the test MSE at ``PARITY.md``'s equal epochs; the device.
The JAX wall times were taken on a TPU and are not quoted.

    python scripts/torch_parity_report.py [--dir docs/parity_port] [--jax_dir docs/parity]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's median best test MSE over the JAX number must lie in this band
# (the spread of EGNN's seeds on both sides of PARITY.md's round 5)
BAND = (0.85, 1.15)
# PARITY.md round 5, which has no JSON for these runs
JAX_EGNN_SEEDS = {43: 0.008870, 44: 0.009066, 45: 0.008093}
EXPERIMENTS = (
    dict(title="N-body 5_0_0, FastEGNN", name="5_0_0", model="FastEGNN", seeds=(43, 44, 45),
         cap=300, marks=(65, 130, 250), jax_json="parity_jax.json",
         ref_json="parity_torch.json"),
    dict(title="N-body 5_0_0, EGNN", name="5_0_0", model="EGNN", seeds=(43, 44, 45), cap=800,
         marks=(65, 130, 250), jax=statistics.mean(JAX_EGNN_SEEDS.values()),
         jax_note=("the mean of the JAX seeds 43 / 44 / 45 "
                   + " / ".join(f"{v:.6f}" for v in JAX_EGNN_SEEDS.values())
                   + " (docs/parity/PARITY.md, round 5)"),
         ref_note="0.00796-0.00994 over its seeds 44 and 43 (docs/parity/PARITY.md, round 5)"),
    dict(title="N-body 5_0_0, VNEGNN", name="5_0_0", model="VNEGNN", seeds=(43,), cap=800,
         marks=(65, 130, 250), jax=0.096542,
         jax_note="seed 43, best at epoch 35, early-stopped at 135 (docs/parity/PARITY.md, round 5)",
         ref_note="0.096623 (docs/parity/PARITY.md, round 5)"),
    dict(title="N-body 100_0_0, FastEGNN", name="100_0_0", model="FastEGNN", seeds=(43,),
         cap=600, marks=(100, 200, 390), jax_json="parity100_jax.json",
         ref_json="parity100_torch.json"),
)


def load(path):
    """``(best, log)`` of a ``[best, log]`` JSON, or None when it is absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        best, log = json.load(f)
    return best, log


def port_path(root: str, name: str, model: str, seed: int) -> str:
    return os.path.join(root, f"{name}_{model.lower()}_s{seed}.json")


def median_ratio(bests, jax_value: float):
    """The median of the runs' best test MSEs and its ratio to ``jax_value``."""
    med = statistics.median(b["loss_test"] for b in bests)
    return med, med / jax_value


def mse_at(log, epoch: int):
    """The test MSE a log holds for ``epoch``, or None."""
    return log["loss"][log["epochs"].index(epoch)] if epoch in log["epochs"] else None


def equal_epoch_rows(logs, marks):
    """``[(epoch, [test MSE of each log or None])]`` at ``marks``."""
    return [(e, [mse_at(log, e) for log in logs]) for e in marks]


def _num(v) -> str:
    return "—" if v is None else f"{v:.6f}"


def experiment_lines(exp: dict, root: str, jax_dir: str):
    lines = [f"## {exp['title']} (cap {exp['cap']} epochs)", ""]
    runs = {s: load(port_path(root, exp["name"], exp["model"], s)) for s in exp["seeds"]}
    done = {s: r for s, r in runs.items() if r is not None}
    jax = load(os.path.join(jax_dir, exp["jax_json"])) if "jax_json" in exp else None
    ref = load(os.path.join(jax_dir, exp["ref_json"])) if "ref_json" in exp else None
    if jax is not None:
        jax_value = jax[0]["loss_test"]
        jax_note = (f"best at epoch {jax[0]['epoch_index']} (docs/parity/{exp['jax_json']})")
    else:
        jax_value, jax_note = exp["jax"], exp["jax_note"]
    ref_note = (f"{ref[0]['loss_test']:.6f} (docs/parity/{exp['ref_json']})" if ref is not None
                else exp["ref_note"])
    notes = [f"- JAX package: {jax_value:.6f}, {jax_note}",
             f"- reference PyTorch code: {ref_note}"]
    if not done:
        return lines + notes + ["", "*(no run of the port yet)*", ""]
    lines += ["| seed | best test MSE | valid | best epoch | early stop | epochs run | "
              "wall s | s / epoch | median step ms |",
              "|---|---|---|---|---|---|---|---|---|"]
    for s, (b, _) in done.items():
        lines.append(
            f"| {s} | {b['loss_test']:.6f} | {b['loss_valid']:.6f} | {b['epoch_index']} | "
            f"{b.get('early_stop', '—')} | {b['epochs_run']} | {b['time_cost']:.1f} | "
            f"{b['seconds_per_epoch']:.3f} | {b['step_ms_median']:.3f} |")
    med, ratio = median_ratio([b for b, _ in done.values()], jax_value)
    inside = BAND[0] <= ratio <= BAND[1]
    missing = [s for s in exp["seeds"] if s not in done]
    lines += ["",
              f"- port, median over seeds {sorted(done)}: **{med:.6f}**"
              + (f" (seeds {missing} not run)" if missing else ""),
              notes[0],
              f"- ratio port / JAX: **{ratio:.3f}**, "
              + ("inside" if inside else "**outside**") + f" the band [{BAND[0]}, {BAND[1]}]",
              notes[1]]
    devices = sorted({b["device"] for b, _ in done.values()})
    draws = sorted({b["data"]["stream"] for b, _ in done.values()})
    lines += [f"- device: {', '.join(devices)}", f"- data: {', '.join(draws)}", ""]
    labels = [f"port s{s}" for s in done] + (["JAX"] if jax else []) + \
        (["reference"] if ref else [])
    logs = [log for _, log in done.values()] + ([jax[1]] if jax else []) + \
        ([ref[1]] if ref else [])
    lines += ["Test MSE at equal epochs:", "",
              "| epoch | " + " | ".join(labels) + " |",
              "|---" * (len(labels) + 1) + "|"]
    for e, vals in equal_epoch_rows(logs, exp["marks"]):
        lines.append(f"| {e} | " + " | ".join(_num(v) for v in vals) + " |")
    return lines + [""]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=os.path.join(REPO, "docs", "parity_port"))
    p.add_argument("--jax_dir", default=os.path.join(REPO, "docs", "parity"))
    a = p.parse_args(argv)
    lines = [
        "# Converged-MSE parity of the PyTorch / CUDA port against the JAX package",
        "",
        "Written by `scripts/torch_parity_report.py` from the `[best, log]` JSONs beside",
        "this file, which `scripts/torch_parity_nbody.py` wrote: the JAX harness's",
        "data, hyperparameters and loop (`scripts/parity_nbody.py`), trained to early",
        "stop or the epoch cap.  `scripts/torch_parity_runs.sh` starts the eight runs",
        "together on one card, each process on one CPU thread; each JSON's `data`",
        "says how its dataset was drawn.",
        "Criterion, fixed before the runs: the median over seeds of the port's best",
        f"test MSE, over the JAX number, in [{BAND[0]}, {BAND[1]}].",
        "The JAX numbers come from `docs/parity/`; its wall times were taken on a",
        "TPU and are not quoted.",
        "",
    ]
    for exp in EXPERIMENTS:
        lines += experiment_lines(exp, a.dir, a.jax_dir)
    os.makedirs(a.dir, exist_ok=True)
    with open(os.path.join(a.dir, "PARITY.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
