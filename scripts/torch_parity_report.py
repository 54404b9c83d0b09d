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

The Water-3D matched experiment (``scripts/torch_parity_simulation.py``)
and the protein one (``scripts/torch_parity_protein.py``) have their JAX
runs beside the port's, in ``{dir}/{water3d|protein}_jax_s{seed}.json``
(``scripts/parity_simulation.py --side jax --matched`` and
``scripts/parity_protein_jax.py``, seeds 43-47, on a CPU), and each is
judged by two criteria that those JSONs alone fix (:func:`seed_criteria`):
(a) the port seeds' median best test MSE inside [min, max] of the JAX
seeds'; (b) at each epoch up to ``band_until`` that every run logged, the
port seeds' median test MSE over the JAX seeds' median inside 1 +- the JAX
seeds' own largest deviation from their median at those epochs, never
tighter than ``band_floor``.  The Water-3D port seeds trained from the JAX
seeds' inits (``--init``) are set beside the same JAX seeds
(:func:`jax_init_lines`).

    python scripts/torch_parity_report.py [--dir docs/parity_port] [--jax_dir docs/parity] \
        [--seeds_jax_dir DIR]
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

# the experiments with their own JAX seeds beside the port's, in
# {dir}/{prefix}_{jax|fastegnn}_s{seed}.json; extra_seeds: more runs a side,
# reported beside the criterion, which they do not change
WATER3D = dict(title="Water-3D matched protocol, FastEGNN (gravity, per-graph MMD)",
               prefix="water3d", subject="Water-3D",
               seeds=(43, 44, 45, 46, 47), cap=700, band_until=200, band_floor=0.05,
               marks=(100, 200, 300, 400, 500, 600, 700), extra_seeds=(48, 49, 50, 51, 52),
               intro=("`scripts/torch_parity_simulation.py` against the unchanged "
                      "`scripts/parity_simulation.py --side jax --matched` (JAX on a CPU): the "
                      "JAX script's synthetic trio (4 trajectories of 200 particles and 300 "
                      "frames per split, seed 7) replayed through one sampling protocol, "
                      "`water3d_protocol.json` beside this file (60 samples per split; batch 10, "
                      "sigma 1.0, weight 0.01, H 64, C 3, L 4, cutoff 0.0, `delta_t` 20, no "
                      "shuffle, an eval every 5 epochs, no early stop). Each side's seeds set "
                      "its own init and MMD draws."))
# (b) at every epoch that all ten runs logged: band_until is the cap
PROTEIN = dict(title="Protein, synthetic AdK chain, FastEGNN (shared MMD draw)",
               prefix="protein", subject="the synthetic AdK chain",
               seeds=(43, 44, 45, 46, 47), cap=150, band_until=150, band_floor=0.05,
               marks=(25, 50, 100, 150),
               intro=("`scripts/torch_parity_protein.py` against "
                      "`scripts/parity_protein_jax.py`, the body of the unchanged "
                      "`scripts/parity_protein.py --side jax` with the seed set (JAX on a CPU): "
                      "`data/protein_parity/synthetic_adk.npz` (60 atoms, 4187 frames, seed 11; "
                      "2481 / 827 / 863 samples, dataset seeds 43 / 44 / 45, the test split "
                      "rotated and translated), batch 50, sigma 1.0, weight 0.5, H 64, C 3, L 4, "
                      "cutoff 0.0, `delta_frame` 15, 10 Angstrom contacts, one MMD draw shared "
                      "by the batch, no shuffle, an eval every 5 epochs, early stop after 100. "
                      "Each side's seeds set its own init and MMD draws."))
# the Water-3D port seeds trained from the JAX seeds' own inits
# (water3d_jax_init_s{seed}.npz), in {dir}/water3d_fastegnn_jaxinit_s{seed}.json;
# the plateau breaks at the first logged test MSE under this
PLATEAU_BREAK = 0.8e-3


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


def extra_seed_lines(root: str, exp: dict, jax_root=None):
    """The best test MSE over every seed run, the criterion's and
    ``exp["extra_seeds"]``, on each side: a line, or none without extra runs."""
    seeds = exp["seeds"] + exp.get("extra_seeds", ())
    bests = {side: [r[0]["loss_test"] for r in (load(seeds_path(d, exp["prefix"], side, s))
                                                 for s in seeds)
                    if r is not None]
             for side, d in (("jax", jax_root or root), ("fastegnn", root))}
    if all(len(v) <= len(exp["seeds"]) for v in bests.values()):
        return []
    j, p = bests["jax"], bests["fastegnn"]
    return [f"Beside the criterion, over seeds {seeds[0]}-{seeds[-1]}: the JAX median best "
            f"test MSE {statistics.median(j):.6f} over {len(j)} seeds, range [{min(j):.6f}, "
            f"{max(j):.6f}]; the port's {statistics.median(p):.6f} over {len(p)} seeds, range "
            f"[{min(p):.6f}, {max(p):.6f}].", ""]


def _num(v, digits: int = 6) -> str:
    return "—" if v is None else f"{v:.{digits}f}"


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


def seeds_path(root: str, prefix: str, side: str, seed: int) -> str:
    """A seeded run's JSON: ``prefix`` is the experiment's, ``side`` is
    ``jax`` or ``fastegnn`` (the port)."""
    return os.path.join(root, f"{prefix}_{side}_s{seed}.json")


def seed_band(jax_logs, until: int, floor: float):
    """``(half width, epoch)`` of criterion (b)'s band: the JAX seeds'
    largest relative deviation from their median test MSE at an epoch all
    of them logged up to ``until``, and where it lies; at least ``floor``."""
    epochs = [e for e in jax_logs[0]["epochs"] if e <= until
              and all(e in log["epochs"] for log in jax_logs)]
    half, at = floor, None
    for e in epochs:
        vals = [mse_at(log, e) for log in jax_logs]
        med = statistics.median(vals)
        dev = max(abs(v / med - 1.0) for v in vals)
        if dev > half:
            half, at = dev, e
    return half, at


def seed_criteria(jax_runs, port_runs, until: int, floor: float) -> dict:
    """Criteria (a) and (b) over ``[(best, log)]`` of the JAX and the port
    seeds, with their numbers."""
    jax_best = [b["loss_test"] for b, _ in jax_runs]
    port_med = statistics.median(b["loss_test"] for b, _ in port_runs)
    lo, hi = min(jax_best), max(jax_best)
    half, half_at = seed_band([log for _, log in jax_runs], until, floor)
    rows = []
    for e in jax_runs[0][1]["epochs"]:
        if e > until:
            continue
        jv = [mse_at(log, e) for _, log in jax_runs]
        pv = [mse_at(log, e) for _, log in port_runs]
        if None in jv or None in pv:
            continue
        ratio = statistics.median(pv) / statistics.median(jv)
        rows.append((e, ratio, abs(ratio - 1.0) <= half))
    return dict(port_median=port_med, jax_min=lo, jax_max=hi, a=lo <= port_med <= hi,
                half=half, half_at=half_at, b_rows=rows,
                b=bool(rows) and all(ok for _, _, ok in rows))


def seeds_lines(root: str, exp: dict, jax_root=None):
    """An experiment with its own JAX seeds: the criteria fixed from them, each
    run, the verdicts and the equal-epoch rows."""
    lines = [f"## {exp['title']} (cap {exp['cap']} epochs)", "", exp["intro"], ""]
    jax = {s: load(seeds_path(jax_root or root, exp["prefix"], "jax", s)) for s in exp["seeds"]}
    jax = {s: r for s, r in jax.items() if r is not None}
    port = {s: load(seeds_path(root, exp["prefix"], "fastegnn", s)) for s in exp["seeds"]}
    port = {s: r for s, r in port.items() if r is not None}
    if not jax:
        return lines + ["*(no JAX run yet)*", ""]
    half, half_at = seed_band([log for _, log in jax.values()], exp["band_until"],
                                 exp["band_floor"])
    jax_best = [b["loss_test"] for b, _ in jax.values()]
    lines += [
        f"Criterion, fixed from the JAX seeds {sorted(jax)} before the port's runs:",
        "",
        f"- (a) the median over the port's seeds of the best test MSE lies in the JAX "
        f"seeds' [min, max] = [{min(jax_best):.6f}, {max(jax_best):.6f}];",
        f"- (b) at each logged epoch <= {exp['band_until']}, the port seeds' median test MSE "
        f"over the JAX seeds' median lies in [{1 - half:.4f}, {1 + half:.4f}]: the JAX "
        f"seeds' largest deviation from their median there ("
        + (f"{half:.4f}, at epoch {half_at}" if half_at is not None else
           f"under {exp['band_floor']}") + f"), never tighter than +-{exp['band_floor']}.",
        "",
        "| side, seed | best test MSE | valid | best epoch | epochs run | wall s | s / epoch | "
        "median step ms | device |",
        "|---|---|---|---|---|---|---|---|---|"]
    # the JAX JSONs carry no device: they were run on the CPU host
    jax_device = "CPU (JAX; the five seeds side by side on 8 cores)"
    for side, runs in (("JAX", jax), ("port", port)):
        for s, (b, log) in runs.items():
            lines.append(
                f"| {side} {s} | {b['loss_test']:.6f} | {b['loss_valid']:.6f} | "
                f"{b['epoch_index']} | {b.get('epochs_run', len(log['loss_train']))} | "
                f"{_num(b.get('time_cost'), 1)} | {_num(b.get('seconds_per_epoch'), 3)} | "
                f"{_num(b.get('step_ms_median'), 3)} | {b.get('device', jax_device)} |")
    lines.append("")
    if port:
        c = seed_criteria(list(jax.values()), list(port.values()), exp["band_until"],
                             exp["band_floor"])
        worst = max(c["b_rows"], key=lambda r: abs(r[1] - 1.0)) if c["b_rows"] else None
        missing = [s for s in exp["seeds"] if s not in port]
        lines += [
            f"- (a) port median best test MSE over seeds {sorted(port)}: **{c['port_median']:.6f}**"
            + (f" (seeds {missing} not run)" if missing else "") + ", "
            + ("**pass**" if c["a"] else "**fail**")
            + f": the JAX range is [{c['jax_min']:.6f}, {c['jax_max']:.6f}].",
            f"- (b) {len(c['b_rows'])} logged epochs <= {exp['band_until']}; "
            + (f"the farthest ratio {worst[1]:.4f} at epoch {worst[0]}; " if worst else "")
            + f"{sum(not ok for _, _, ok in c['b_rows'])} outside [{1 - c['half']:.4f}, "
            f"{1 + c['half']:.4f}]: " + ("**pass**" if c["b"] else "**fail**") + ".",
            "", "In plain words: " + (
                f"both criteria pass; the port converges on {exp['subject']} as the JAX "
                "package does."
                if c["a"] and c["b"] else
                "the port fails " + " and ".join(k for k in ("(a)", "(b)")
                                                 if not c[k[1]]) + "."),
            ""] + extra_seed_lines(root, exp, jax_root) + [
            "Port / JAX median test MSE at the logged epochs <= "
            f"{exp['band_until']}:", "",
            "| epoch | ratio | in band |", "|---|---|---|"]
        lines += [f"| {e} | {r:.4f} | {'yes' if ok else '**no**'} |" for e, r, ok in c["b_rows"]]
        lines.append("")
    else:
        lines += ["*(no run of the port yet)*", ""]
    labels = [f"JAX s{s}" for s in jax] + [f"port s{s}" for s in port]
    logs = [log for _, log in jax.values()] + [log for _, log in port.values()]
    lines += ["Test MSE at equal epochs:", "",
              "| epoch | " + " | ".join(labels) + " | JAX median | port median |",
              "|---" * (len(labels) + 3) + "|"]
    for e, vals in equal_epoch_rows(logs, exp["marks"]):
        jv, pv = vals[:len(jax)], vals[len(jax):]
        med = [statistics.median(v) if v and None not in v else None for v in (jv, pv)]
        lines.append(f"| {e} | " + " | ".join(_num(v) for v in vals + med) + " |")
    return lines + [""]


def plateau_break(log, below: float = PLATEAU_BREAK):
    """The first logged epoch whose test MSE is under ``below``, or None."""
    return next((e for e, v in zip(log["epochs"], log["loss"]) if v < below), None)


def jax_init_lines(root: str, exp: dict = WATER3D, jax_root=None):
    """The Water-3D port seeds trained from the JAX seeds' inits, each beside
    the same JAX seed and the port seed from its own init; their median
    against criterion (a)'s range, which they leave as it is."""
    lines = [f"## {exp['title']}, the port from the JAX inits (cap {exp['cap']} epochs)", "",
             "Each port seed starts from the weights the same JAX seed starts from "
             "(`water3d_jax_init_s<seed>.npz` beside this file, the JAX harness's init "
             "exported on the CPU; `scripts/torch_parity_simulation.py --init`); its MMD "
             "draws stay the port's own. This separates the init from the numerics; "
             f"criterion (a) above is not changed by it. Plateau break: the first logged "
             f"epoch with test MSE under {PLATEAU_BREAK:g}.", ""]
    rows = []
    for s in exp["seeds"]:
        runs = [load(seeds_path(jax_root or root, exp["prefix"], "jax", s)),
                load(os.path.join(root, f"{exp['prefix']}_fastegnn_jaxinit_s{s}.json")),
                load(seeds_path(root, exp["prefix"], "fastegnn", s))]
        if runs[1] is not None:
            rows.append((s, runs))
    if not rows:
        return lines + ["*(no run of the port from the JAX inits yet)*", ""]
    lines += ["| seed | JAX best | JAX break | port from JAX init best | its break | "
              "port from own init best | its break | device |",
              "|---|---|---|---|---|---|---|---|"]
    for s, runs in rows:
        cells = []
        for r in runs:
            cells += ["—", "—"] if r is None else [f"{r[0]['loss_test']:.6f}",
                                                   str(plateau_break(r[1]) or "—")]
        lines.append(f"| {s} | " + " | ".join(cells) + f" | {runs[1][0]['device']} |")
    jax_best = [r[0]["loss_test"] for r in (load(seeds_path(jax_root or root, exp["prefix"],
                                                            "jax", s)) for s in exp["seeds"])
                if r is not None]
    med = statistics.median(runs[1][0]["loss_test"] for _, runs in rows)
    lo, hi = min(jax_best), max(jax_best)
    missing = [s for s in exp["seeds"] if s not in dict(rows)]
    lines += ["", f"- port from the JAX inits, median best test MSE over seeds "
              f"{[s for s, _ in rows]}: **{med:.6f}**"
              + (f" (seeds {missing} not run)" if missing else "") + ", "
              + ("inside" if lo <= med <= hi else "**outside**")
              + f" the JAX range [{lo:.6f}, {hi:.6f}].", ""]
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=os.path.join(REPO, "docs", "parity_port"))
    p.add_argument("--jax_dir", default=os.path.join(REPO, "docs", "parity"))
    p.add_argument("--seeds_jax_dir", default=None,
                   help="the Water-3D and protein JAX JSONs' directory (default --dir)")
    a = p.parse_args(argv)
    lines = [
        "# Converged-MSE parity of the PyTorch / CUDA port against the JAX package",
        "",
        "Written by `scripts/torch_parity_report.py` from the `[best, log]` JSONs beside",
        "this file.  N-body: `scripts/torch_parity_nbody.py` wrote them, with the JAX",
        "harness's data, hyperparameters and loop (`scripts/parity_nbody.py`), trained",
        "to early stop or the epoch cap.  `scripts/torch_parity_runs.sh` starts those",
        "eight runs together on one card, each process on one CPU thread; each JSON's",
        "`data` says how its dataset was drawn.",
        "Their criterion, fixed before the runs: the median over seeds of the port's",
        f"best test MSE, over the JAX number, in [{BAND[0]}, {BAND[1]}].",
        "Their JAX numbers come from `docs/parity/`; its wall times were taken on a",
        "TPU and are not quoted.  Water-3D and protein, the last sections, have their",
        "own JAX runs and criteria.",
        "",
    ]
    for exp in EXPERIMENTS:
        lines += experiment_lines(exp, a.dir, a.jax_dir)
    lines += seeds_lines(a.dir, WATER3D, a.seeds_jax_dir)
    lines += jax_init_lines(a.dir, WATER3D, a.seeds_jax_dir)
    lines += seeds_lines(a.dir, PROTEIN, a.seeds_jax_dir)
    os.makedirs(a.dir, exist_ok=True)
    with open(os.path.join(a.dir, "PARITY.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
