"""Protein MD dataset (AdK equilibrium trajectory -> padded graphs;
counterpart of ``fastegnn_tpu/data/protein.py``, the same arrays from the
same ``.npz``).

Two stages, as in the JAX package:

1. :func:`preprocess_adk`: host-side, needs MDAnalysis and MDAnalysisData;
   fetches the AdK equilibrium dataset and writes plain arrays to one
   ``.npz`` (positions, velocities, charges, bonds, box dimensions), as
   reference ``datasets/protein/dataset.py:81-129`` reads them.
2. :class:`ProteinDataset`: reads the ``.npz`` only:
   - fixed split counts 2481/827/863 scaled to shorter trajectories
     (``:54``);
   - frames (t, t+delta_frame), delta_frame=15 in the reference protein CLI;
   - ``contact_cutoff`` (10 Angstrom) contact-graph edges (``:146-150``)
     then the shortest ``(1-cutoff_rate)`` fraction (``:208-213``), padded
     to ``max_edges`` (the split's most, where not given);
   - node features [|v|, q / max(q)] (``:158-161``);
   - the test split's random rotation and translation (scaled by half the
     box, ``:131-142``), each where ``test_rot`` / ``test_trans`` asks for
     it, drawn in that order from ``seed``;
   - fibonacci-sphere virtual positions for VNEGNN (``:176-205``): each
     graph carries ``virtual_fibonacci`` [1, 3, C] when C > 1, and its
     batches ``GraphBatch.virtual_fibonacci`` [B, 3, C].

``bond_edges`` gives the covalent-bond graph (EGHN's local edges,
``:216-224``).  With ``with_local_edges`` (the protein CLI's ``--model
EGHN``) every graph carries those bonds as its local edges, with
``[topology length, frame-0 length]`` attributes (reference
``utils/train.py:71-76``), and its batches their CSR orders
(``graph.py``).
:func:`make_synthetic_protein_npz` writes a fixture of the same schema
where MDAnalysis or the download is not available.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from fastegnn_tpu_torch.data.batcher import GraphDataset
from fastegnn_tpu_torch.graph import GraphSpec, pad_graph
from fastegnn_tpu_torch.ops.neighbors import radius_graph_np, sort_cutoff_np
from fastegnn_tpu_torch.ops.rotation import random_rotation


def preprocess_adk(data_dir: str, out_path: str, backbone: bool = False) -> None:
    """Extract the AdK equilibrium MD trajectory to a plain ``.npz``.

    Needs MDAnalysis and MDAnalysisData (host side only; training reads
    the ``.npz``)."""
    try:
        import MDAnalysis
        import MDAnalysisData
    except ImportError as e:
        raise ImportError(
            "preprocess_adk needs MDAnalysis and MDAnalysisData installed; "
            "run on a host with them available, then ship the .npz"
        ) from e

    adk = MDAnalysisData.datasets.fetch_adk_equilibrium(data_home=data_dir)
    u = MDAnalysis.Universe(adk.topology, adk.trajectory)
    ag = u.select_atoms("backbone") if backbone else u.atoms
    ix = ag.ix
    charges = u.atoms[ix].charges.astype(np.float32)[:, None]

    n_frames = len(u.trajectory)
    positions = np.empty((n_frames, len(ix), 3), np.float32)
    has_vel = True
    velocities = np.zeros_like(positions)
    dims = None
    for t in range(n_frames):
        # frame reads retry 10 times on OSError, as the reference does
        # (datasets/protein/dataset.py:99-122): network-backed DCD reads
        # fail transiently
        ts = None
        for retry in range(10):
            try:
                ts = u.trajectory[t]
                break
            except OSError:
                print(f"Reading error at frame {t} (retry {retry + 1}/10)")
        if ts is None:
            raise OSError(f"Failed to read frame {t} after 10 retries")
        positions[t] = ts.positions[ix]
        if ts.has_velocities:
            velocities[t] = ts.velocities[ix]
        else:
            has_vel = False
        if dims is None:
            dims = np.asarray(ts.dimensions[:3], np.float32)
    if not has_vel:
        velocities[:-1] = positions[1:] - positions[:-1]
        velocities[-1] = velocities[-2]

    bonds = u.bonds.indices.astype(np.int32)
    # keep only bonds inside the selection, remapped to selection indices
    sel = np.full(u.atoms.n_atoms, -1, np.int32)
    sel[ix] = np.arange(len(ix), dtype=np.int32)
    keep = (sel[bonds[:, 0]] >= 0) & (sel[bonds[:, 1]] >= 0)
    bonds = np.stack([sel[bonds[keep, 0]], sel[bonds[keep, 1]]], axis=1)
    bond_lengths = np.linalg.norm(
        positions[0][bonds[:, 0]] - positions[0][bonds[:, 1]], axis=1
    ).astype(np.float32)

    np.savez_compressed(out_path, positions=positions, velocities=velocities,
                        charges=charges, bonds=bonds, bond_lengths=bond_lengths,
                        dimensions=dims)


def make_synthetic_protein_npz(
    out_path: str, n_atoms: int = 120, n_frames: int = 80, seed: int = 0
) -> None:
    """A fixture of the ``.npz`` schema: a jiggling random chain (the JAX
    package's arrays for the same arguments)."""
    rng = np.random.default_rng(seed)
    # chain layout so a bond graph exists
    base = np.cumsum(rng.normal(scale=1.5, size=(n_atoms, 3)), axis=0).astype(np.float32)
    positions = np.empty((n_frames, n_atoms, 3), np.float32)
    x = base.copy()
    for t in range(n_frames):
        x = x + rng.normal(scale=0.05, size=x.shape).astype(np.float32)
        positions[t] = x
    velocities = np.zeros_like(positions)
    velocities[:-1] = positions[1:] - positions[:-1]
    velocities[-1] = velocities[-2]
    bonds = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)], axis=1).astype(np.int32)
    np.savez_compressed(
        out_path,
        positions=positions,
        velocities=velocities,
        charges=rng.normal(size=(n_atoms, 1)).astype(np.float32),
        bonds=bonds,
        bond_lengths=np.linalg.norm(
            positions[0][bonds[:, 0]] - positions[0][bonds[:, 1]], axis=1
        ).astype(np.float32),
        dimensions=np.array([60.0, 60.0, 60.0], np.float32),
    )


def _fibonacci_sphere(samples: int) -> np.ndarray:
    """Evenly distributed unit-sphere points (ref ``dataset.py:184-199``)."""
    pts = []
    phi = math.pi * (math.sqrt(5.0) - 1.0)
    for i in range(samples):
        y = 1 - (i / float(max(samples - 1, 1))) * 2
        r = math.sqrt(max(1 - y * y, 0.0))
        theta = phi * i
        pts.append([math.cos(theta) * r, y, math.sin(theta) * r])
    return np.asarray(pts, np.float32)


class ProteinDataset(GraphDataset):
    """One split of a trajectory ``.npz``, batched onto ``device`` (the card
    unless ``"cpu"``)."""

    SPLITS = (2481, 827, 863)  # reference dataset.py:54

    def __init__(
        self,
        npz_path: str,
        partition: str = "train",
        device=None,
        virtual_channels: int = 3,
        cutoff_rate: float = 0.0,
        max_samples: int = int(1e8),
        delta_frame: int = 15,
        contact_cutoff: float = 10.0,
        test_rot: bool = True,
        test_trans: bool = True,
        seed: int = 0,
        max_edges: Optional[int] = None,
        with_local_edges: bool = False,
    ):
        data = np.load(npz_path)
        pos, vel = data["positions"], data["velocities"]
        charges, dims = data["charges"], data["dimensions"]
        self._bonds = data["bonds"]
        self._bond_lengths = data["bond_lengths"]

        usable = pos.shape[0] - delta_frame - 1
        total = sum(self.SPLITS)
        counts = [max(1, int(usable * s / total)) for s in self.SPLITS]
        starts = [0, counts[0], counts[0] + counts[1]]
        idx = {"train": 0, "valid": 1, "test": 2}[partition]
        lo = starts[idx]
        hi = min(lo + counts[idx], usable)

        rng = np.random.default_rng(seed)
        raw = []
        for t in range(lo, min(hi, lo + max_samples)):
            loc_0 = pos[t].astype(np.float32)
            loc_t = pos[t + delta_frame].astype(np.float32)
            vel_0 = vel[t].astype(np.float32)
            if partition == "test" and test_rot:
                R = random_rotation(rng).astype(np.float32)
                loc_0, loc_t, vel_0 = loc_0 @ R, loc_t @ R, vel_0 @ R
            if partition == "test" and test_trans:
                tr = (rng.standard_normal(3) * dims / 2).astype(np.float32)
                loc_0, loc_t = loc_0 + tr, loc_t + tr
            dst, src = radius_graph_np(loc_0, contact_cutoff)
            dst, src = sort_cutoff_np(dst, src, loc_0, cutoff_rate)
            d0 = np.linalg.norm(loc_0[dst] - loc_0[src], axis=1, keepdims=True)
            node_feat = np.concatenate(
                [np.linalg.norm(vel_0, axis=1, keepdims=True), charges / charges.max()],
                axis=1).astype(np.float32)
            entry = dict(
                node_feat=node_feat, coord=loc_0, vel=vel_0, dst=dst, src=src,
                edge_attr=np.concatenate([d0, d0], axis=1).astype(np.float32),
                coord_target=loc_t, node_attr=charges.astype(np.float32))
            if with_local_edges:
                bd, bs = self._bonds[:, 0], self._bonds[:, 1]
                blen = np.linalg.norm(loc_0[bd] - loc_0[bs], axis=1,
                                      keepdims=True).astype(np.float32)
                entry.update(local_dst=bd.astype(np.int32), local_src=bs.astype(np.int32),
                             local_edge_attr=np.concatenate(
                                 [self._bond_lengths[:, None].astype(np.float32), blen], axis=1))
            raw.append(entry)

        spec = GraphSpec(
            max_nodes=pos.shape[1],
            max_edges=max_edges or max(r["dst"].shape[0] for r in raw),
            n_graphs=1, node_feat_dim=2, edge_attr_dim=2, node_attr_dim=1,
            virtual_channels=virtual_channels,
            max_local_edges=self._bonds.shape[0] if with_local_edges else 0)
        graphs = []
        for r in raw:
            g = pad_graph(spec, **r)
            if virtual_channels > 1:
                loc = r["coord"]
                center = loc.mean(axis=0, keepdims=True)
                radius = np.linalg.norm(loc - center, axis=1).max()
                fib = _fibonacci_sphere(virtual_channels) * radius + center
                g["virtual_fibonacci"] = fib.T[None]  # [1, 3, C]
            graphs.append(g)
        super().__init__(graphs, spec, device)

    def bond_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Covalent-bond local edges and their lengths (EGHN, ref ``:216-224``)."""
        return self._bonds, self._bond_lengths
