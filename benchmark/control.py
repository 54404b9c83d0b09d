"""The readings that a cell's limits are set from: the compared numbers of
sound runs of the program, of the control, and of the program with a
fault planted, over several seeds, at the cell's own size.

    python3 benchmark/control.py --workload water3d-train --seeds 1,2,3 \
        --control 1,2,3 --faults half,output,batch [--out FILE]

For each seed the cell's set-up and checked steps run as in a benchmark
run (no window), then the reference; each line printed is one JSON object
``{"seed", "side", "numbers"}``:

- ``program``: the program as it is;
- ``control``: the reference computed with TF32 on, in the program's
  place (the nearest precision below the configurations' f32);
- ``half``: the MSE over half of the batch's rows, the mean taken over the
  rest (``train.step.masked_mse`` replaced);
- ``output``: one predicted coordinate of every forward moved by 0.01
  (a forward hook on the model), an answer altered where it is produced;
- ``batch``: one target coordinate of every collated batch moved by 0.01
  (``GraphDataset.host_collate`` wrapped), the batch altered where it is
  produced;
- ``unchanged``: Adam's step does nothing, the state is left unchanged
  (reads 1 by the update measure; a CPU test runs it).

The benchmark's own runs never run this.  ``faults(...)`` is what the
tests plant too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the folder would shadow modules of the same names
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("half", "output", "batch", "unchanged")
DELTA = 0.01


@contextlib.contextmanager
def fault(name: str):
    """The program with the fault ``name`` planted, while the block runs."""
    from benchmark import harness
    from fastegnn_tpu_torch.data.batcher import GraphDataset
    from fastegnn_tpu_torch.train import optim as port_optim
    from fastegnn_tpu_torch.train import step as port_step

    undo = []

    def swap(obj, attr, new):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "half":
        orig_mse = port_step.masked_mse

        def half_mse(pred, target, mask):
            keep = mask.clone()
            keep[mask.shape[0] // 2:] = False
            return orig_mse(pred, target, keep)

        swap(port_step, "masked_mse", half_mse)
    elif name == "output":
        orig_build = harness.build_program

        def altered(module, inputs, out):
            x = out[0].clone()
            x[0, 0] += DELTA
            return (x,) + tuple(out[1:])

        def build(*a, **k):
            model, opt, step = orig_build(*a, **k)
            model.register_forward_hook(altered)
            return model, opt, step

        swap(harness, "build_program", build)
    elif name == "batch":
        orig_collate = GraphDataset.host_collate

        def collate(self, indices):
            b = orig_collate(self, indices)
            b.coord_target = b.coord_target.clone()
            b.coord_target[0, 0] += DELTA
            return b

        swap(GraphDataset, "host_collate", collate)
    elif name == "unchanged":
        orig_adam = port_optim.torch_adam

        def frozen_adam(*a, **k):
            opt = orig_adam(*a, **k)
            opt.step = lambda *args, **kw: None
            return opt

        swap(port_optim, "torch_adam", frozen_adam)
    else:
        raise ValueError(f"unknown fault {name!r} (have {FAULTS})")
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)


def readings(workload: str, seed: int, side: str, device: str = "cuda", data=None,
             **where) -> dict:
    """The compared numbers of one seed on one side."""
    from benchmark import harness

    cell, dev, on_card = harness.start(workload, device, **where)
    t0 = time.perf_counter()
    if side == "control":
        su = harness.Setup(cell, seed, dev, t0, data=data)
        su.free(on_card)
        return harness.reference_check(cell.config, su.raw, su.weights, su.checked, su.n_max,
                                       dev, tf32=True)
    with (fault(side) if side != "program" else contextlib.nullcontext()):
        su = harness.Setup(cell, seed, dev, t0, data=data)
        su.free(on_card)
    return harness.reference_check(cell.config, su.raw, su.weights, su.checked, su.n_max, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds of sound runs")
    p.add_argument("--control", default="", help="seeds of the control")
    p.add_argument("--faults", default="", help="comma-separated faults, on the control's seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness, inputs

    if not torch.cuda.is_available():
        harness.say("needs a CUDA card")
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control.split(",") if s]
    faults = [f for f in args.faults.split(",") if f]
    cell, dev, _ = harness.start(args.workload, "cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | set(control)):
            data = inputs.build(cell.config, seed, dev)
            sides = (["program"] if seed in seeds else []) + (
                ["control"] + faults if seed in control else [])
            for side in sides:
                t0 = time.perf_counter()
                nums = readings(args.workload, seed, side, data=data)
                line = json.dumps({"workload": args.workload, "seed": seed, "side": side,
                                   "numbers": nums, "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            del data
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
