"""The raw inputs of a cell, made from ``--seed``, and the port's dataset
built from them.

The generators are frozen copies of the port's synthetic data
(``data/simulation.py::_falling_particles``, ``data/protein.py::
make_synthetic_protein_npz``), so that a change to the program cannot
change what the benchmark feeds it.  What a seed may change is chosen so
that every seed gives the same amount of work:

- Water-3D: the particles' draws and the batch order change with the
  seed; the frames sampled from each trajectory are the configuration's,
  the same for every seed (the falling particles' density, and with it
  the edge count, depends strongly on the frame).
- protein: the chain's shape is drawn from the configuration's fixed
  ``structure_seed`` (one protein, as a user trains on one); its thermal
  jiggle and charges change with the seed.

:class:`RawPool` holds, for every graph of the pool in the dataset's
order, the frames it is made from, so that the reference rebuilds each
graph from them.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import List

import numpy as np


@dataclasses.dataclass
class RawGraph:
    """One sample: positions at t, velocity at t, positions at t + delta,
    and the per-node scalar (particle type or charge)."""

    loc: np.ndarray        # [n, 3] f32
    vel: np.ndarray        # [n, 3] f32
    target: np.ndarray     # [n, 3] f32
    scalar: np.ndarray     # [n, 1] f32


@dataclasses.dataclass
class RawPool:
    kind: str
    graphs: List[RawGraph]


def falling_particles(rng: np.random.Generator, n: int, n_frames: int) -> np.ndarray:
    """Particles falling under gravity in a unit box with damping, noise and
    reflective walls: ``[n_frames, n, 3]`` f32."""
    x = rng.random((n, 3)).astype(np.float32) * 0.4 + 0.3
    v = rng.normal(size=(n, 3)).astype(np.float32) * 1e-3
    traj = np.empty((n_frames, n, 3), np.float32)
    for t in range(n_frames):
        v[:, 1] -= 1e-4
        v *= 0.999
        v += rng.normal(size=(n, 3)).astype(np.float32) * 1e-5
        x = x + v
        for d in range(3):
            low, high = x[:, d] < 0.0, x[:, d] > 1.0
            x[low, d] *= -1.0
            x[high, d] = 2.0 - x[high, d]
            v[low | high, d] *= -1.0
        traj[t] = x
    return traj


def water3d_trajectories(data: dict, seed: int):
    """``[(key, particle_type [n, 1], position [T, n, 3])]`` of the pool."""
    rng = np.random.default_rng(seed)
    return [(f"traj_{i}", np.full((data["n_particles"], 1), data["particle_type"], np.float32),
             falling_particles(rng, data["n_particles"], data["n_frames"]))
            for i in range(data["n_trajectories"])]


def protein_arrays(data: dict, seed: int) -> dict:
    """The trajectory arrays of a synthetic chain (the ``.npz`` schema the
    port's protein dataset reads): a random-walk backbone from
    ``structure_seed``, jiggled frame by frame from ``seed``."""
    n, n_frames = data["n_atoms"], data["n_frames"]
    base = np.cumsum(np.random.default_rng(data["structure_seed"]).normal(
        scale=1.5, size=(n, 3)), axis=0).astype(np.float32)
    rng = np.random.default_rng(seed)
    positions = np.empty((n_frames, n, 3), np.float32)
    x = base.copy()
    for t in range(n_frames):
        x = x + rng.normal(scale=0.05, size=x.shape).astype(np.float32)
        positions[t] = x
    velocities = np.zeros_like(positions)
    velocities[:-1] = positions[1:] - positions[:-1]
    velocities[-1] = velocities[-2]
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).astype(np.int32)
    return dict(
        positions=positions, velocities=velocities,
        charges=rng.normal(size=(n, 1)).astype(np.float32), bonds=bonds,
        bond_lengths=np.linalg.norm(positions[0][bonds[:, 0]] - positions[0][bonds[:, 1]],
                                    axis=1).astype(np.float32),
        dimensions=np.array([60.0, 60.0, 60.0], np.float32))


def build(cfg: dict, seed: int, device):
    """``(dataset, raw)``: the port's training dataset of the pool on
    ``device`` and the raw samples it was made from, in its order."""
    data = cfg["dataset"]
    if data["kind"] == "water3d":
        return _water3d(cfg, data, seed, device)
    if data["kind"] == "protein":
        return _protein(cfg, data, seed, device)
    raise ValueError(f"unknown dataset kind {data['kind']!r}")


def _water3d(cfg, data, seed, device):
    from fastegnn_tpu_torch.data.simulation import SimulationDataset

    trajectories = water3d_trajectories(data, seed)
    frames = [int(f) for f in data["frames"]]
    n_pool = cfg["train_pool"]
    if n_pool != len(frames) * len(trajectories):
        raise ValueError("train_pool must be trajectories x frames")
    protocol = {"frames": {k: frames for k, _, _ in trajectories}, "rot_deg": [],
                "order": list(range(n_pool))}
    ds = SimulationDataset.from_trajectories(
        trajectories, "train", device=device, virtual_channels=cfg["virtual_channels"],
        cutoff_rate=cfg["cutoff_rate"], max_samples=n_pool, delta_t=cfg["delta_t"],
        radius=cfg["radius"], frames_per_trajectory=len(frames), protocol=protocol)
    dt = cfg["delta_t"]
    raw = [RawGraph(loc=pos[t], vel=pos[t + 1] - pos[t], target=pos[t + dt], scalar=ptype)
           for _, ptype, pos in trajectories for t in frames]
    return ds, RawPool("water3d", raw)


def _protein(cfg, data, seed, device):
    from fastegnn_tpu_torch.data.protein import ProteinDataset

    arrays = protein_arrays(data, seed)
    fd, path = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        np.savez(path, **arrays)
        ds = ProteinDataset(path, partition="train", device=device,
                            virtual_channels=cfg["virtual_channels"],
                            cutoff_rate=cfg["cutoff_rate"], max_samples=cfg["train_pool"],
                            delta_frame=cfg["delta_frame"],
                            contact_cutoff=cfg["radius"], seed=seed)
    finally:
        os.remove(path)
    if len(ds) != cfg["train_pool"]:
        raise ValueError(f"the chain gives {len(ds)} training samples, not "
                         f"{cfg['train_pool']}: raise n_frames")
    pos, vel, q = arrays["positions"], arrays["velocities"], arrays["charges"]
    d = cfg["delta_frame"]
    raw = [RawGraph(loc=pos[t], vel=vel[t], target=pos[t + d], scalar=q)
           for t in range(cfg["train_pool"])]
    return ds, RawPool("protein", raw)
