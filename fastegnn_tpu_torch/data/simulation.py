"""Water-3D particle-simulation dataset (counterpart of
``fastegnn_tpu/data/simulation.py``).

Loader semantics are the JAX package's (reference
``datasets/simulation/dataset.py``):

- each trajectory holds ``particle_type`` [n] and ``position`` [T, n, 3];
- up to 15 random frames per trajectory from [0, 250];
- velocity = one-step finite difference ``x[t+1]-x[t]``; target =
  ``x[t+delta_t]``;
- radius graph r=0.035 with unbounded neighbours, then the shortest
  ``(1-cutoff_rate)`` fraction kept;
- node features [|v|, type/max(type)];
- the *test* split gets a random y-axis rotation (gravity-aligned) once at
  construction;
- samples shuffled after processing.

The numpy generator is consumed in the JAX package's order (the frames of
each trajectory, then one rotation per test sample, then the shuffle), so
both packages build the same arrays from the same file and seed.

Reading trajectories is apart from making samples: :class:`SimulationDataset`
reads an h5 file, :meth:`SimulationDataset.from_trajectories` takes them
from memory, e.g. from :func:`synthetic_trajectories`, the numpy body of
:func:`make_synthetic_simulation_h5`.  ``h5py`` is imported only by the
functions that read or write a file.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from fastegnn_tpu_torch.data.batcher import GraphDataset
from fastegnn_tpu_torch.graph import GraphSpec, pad_graph
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np, sort_cutoff_np
from fastegnn_tpu_torch.ops.rotation import random_rotation_y, rotation_y

SPLITS = ("train", "valid", "test")
# (key, particle_type [n, 1] f32, position [T, n, 3] f32)
Trajectory = Tuple[str, np.ndarray, np.ndarray]


def read_trajectories(path: str) -> Iterator[Trajectory]:
    """The trajectories of one h5 split file, in the file's order."""
    import h5py

    with h5py.File(path, "r") as f:
        for k in list(f.keys()):
            yield (k, np.asarray(f[k]["particle_type"], np.float32)[:, None],
                   np.asarray(f[k]["position"], np.float32))


def simulation_graphs(
    trajectories: Iterable[Trajectory],
    partition: str = "train",
    virtual_channels: int = 3,
    cutoff_rate: float = 0.0,
    max_samples: int = int(1e8),
    delta_t: int = 15,
    radius: float = 0.035,
    frames_per_trajectory: int = 15,
    frame_range: int = 250,
    seed: int = 0,
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    protocol: Optional[dict] = None,
) -> Tuple[List[dict], GraphSpec]:
    """The padded graphs and per-graph spec of one split.

    ``protocol``: replay a recorded sampling protocol: a dict with ``frames``
    {trajectory key: [frame, ...]}, ``rot_deg`` [degrees per sample in
    processing order] and ``order`` (the permutation that replaces the
    post-processing shuffle)."""
    rng = np.random.default_rng(seed)
    samples = []  # raw (loc_0, vel_0, loc_t, node_type)
    for k, ptype, pos in trajectories:
        n_frames = min(frames_per_trajectory, max_samples - len(samples))
        hi = min(frame_range, pos.shape[0] - delta_t - 2)
        if protocol is not None:
            frames = np.asarray(protocol["frames"][k][:n_frames])
        else:
            frames = rng.integers(0, hi + 1, size=n_frames)
        for t in frames:
            samples.append((pos[t], pos[t + 1] - pos[t], pos[t + delta_t], ptype))
        if len(samples) >= max_samples:
            break

    raw = []
    for si, (loc_0, vel_0, loc_t, ptype) in enumerate(samples):
        if partition == "test":
            if protocol is not None:
                R = rotation_y(np.radians(protocol["rot_deg"][si])).astype(np.float32)
            else:
                R = random_rotation_y(rng).astype(np.float32)
            loc_0, loc_t, vel_0 = loc_0 @ R, loc_t @ R, vel_0 @ R
        dst, src = radius_graph_np(loc_0, radius)
        dst, src = sort_cutoff_np(dst, src, loc_0, cutoff_rate)
        d0 = np.linalg.norm(loc_0[dst] - loc_0[src], axis=1, keepdims=True)
        node_feat = np.concatenate(
            [np.linalg.norm(vel_0, axis=1, keepdims=True), ptype / max(ptype.max(), 1e-12)],
            axis=1).astype(np.float32)
        raw.append(dict(node_feat=node_feat, coord=loc_0, vel=vel_0, dst=dst, src=src,
                        edge_attr=np.concatenate([d0, d0], axis=1).astype(np.float32),
                        coord_target=loc_t, node_attr=ptype))

    spec = GraphSpec(
        max_nodes=max_nodes or max(r["coord"].shape[0] for r in raw),
        max_edges=max_edges or max(r["dst"].shape[0] for r in raw),
        n_graphs=1, node_feat_dim=2, edge_attr_dim=2, node_attr_dim=1,
        virtual_channels=virtual_channels)
    graphs = [pad_graph(spec, **r) for r in raw]
    if protocol is not None:
        graphs = [graphs[i] for i in protocol["order"]]
    else:
        rng.shuffle(graphs)
    return graphs, spec


class SimulationDataset(GraphDataset):
    """One split of a Water-3D h5 trio (``{data_dir}/{dataset_name}/
    {partition}.h5``); keyword arguments as :func:`simulation_graphs`, plus
    ``device``."""

    def __init__(self, data_dir: str, dataset_name: str = "Water-3D",
                 partition: str = "train", device=None, **options):
        path = os.path.join(data_dir, dataset_name, f"{partition}.h5")
        with contextlib.closing(read_trajectories(path)) as trajectories:
            graphs, spec = simulation_graphs(trajectories, partition, **options)
        super().__init__(graphs, spec, device)

    @classmethod
    def from_trajectories(cls, trajectories: Iterable[Trajectory],
                          partition: str = "train", device=None,
                          **options) -> "SimulationDataset":
        """The same dataset from trajectories held in memory."""
        self = cls.__new__(cls)
        graphs, spec = simulation_graphs(trajectories, partition, **options)
        GraphDataset.__init__(self, graphs, spec, device)
        return self


def _falling_particles(rng: np.random.Generator, n: int, n_frames: int) -> np.ndarray:
    x = rng.random((n, 3)).astype(np.float32) * 0.4 + 0.3
    v = rng.normal(size=(n, 3)).astype(np.float32) * 1e-3
    traj = np.empty((n_frames, n, 3), np.float32)
    for t in range(n_frames):
        v[:, 1] -= 1e-4           # gravity
        v *= 0.999                # damping
        v += rng.normal(size=(n, 3)).astype(np.float32) * 1e-5
        x = x + v
        # reflective box walls
        for d in range(3):
            low, high = x[:, d] < 0.0, x[:, d] > 1.0
            x[low, d] *= -1.0
            x[high, d] = 2.0 - x[high, d]
            v[low | high, d] *= -1.0
        traj[t] = x
    return traj


def synthetic_trajectories(
    n_trajectories: int = 2,
    n_particles: int = 200,
    n_frames: int = 300,
    seed: int = 0,
) -> Dict[str, List[Trajectory]]:
    """``{split: [trajectory, ...]}`` of the synthetic Water-3D trio:
    particles falling under gravity inside a unit box with damping and
    noise, drawn in the order :func:`make_synthetic_simulation_h5` writes
    them (and as the JAX package's generator of that name does)."""
    rng = np.random.default_rng(seed)
    out = {}
    for split in SPLITS:
        out[split] = [(f"traj_{i}", np.full((n_particles, 1), 5.0, np.float32),
                       _falling_particles(rng, n_particles, n_frames))
                      for i in range(n_trajectories)]
    return out


def make_synthetic_simulation_h5(path: str, n_trajectories: int = 2, n_particles: int = 200,
                                 n_frames: int = 300, seed: int = 0) -> None:
    """Write :func:`synthetic_trajectories` as a schema-compatible
    ``{train,valid,test}.h5`` trio under ``path``."""
    import h5py

    os.makedirs(path, exist_ok=True)
    for split, trajs in synthetic_trajectories(n_trajectories, n_particles, n_frames,
                                               seed).items():
        with h5py.File(os.path.join(path, f"{split}.h5"), "w") as f:
            for key, ptype, pos in trajs:
                g = f.create_group(key)
                g.create_dataset("particle_type", data=ptype[:, 0])
                g.create_dataset("position", data=pos)
