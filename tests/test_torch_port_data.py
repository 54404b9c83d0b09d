"""The port's Water-3D datasets and batch streaming against the JAX package.

The same synthetic h5 trio (written by the JAX package's generator) goes
through ``fastegnn_tpu.data.simulation`` and
``fastegnn_tpu_torch.data.simulation``; the splits must be the same arrays,
exactly, with and without a recorded sampling protocol, and the batches
must come in the same order.
"""

import h5py
import numpy as np
import pytest
import torch

from fastegnn_tpu.data import simulation as jsim
from fastegnn_tpu_torch.data import simulation as psim
from fastegnn_tpu_torch.data.batcher import GraphDataset

N_TRAJ, N_PART, N_FRAMES = 2, 40, 40
# a few samples per trajectory, so that max_samples stops inside the second;
# a radius that gives the 40 particles ~140 edges per sample
OPTS = dict(virtual_channels=3, cutoff_rate=0.25, max_samples=7, seed=5,
            frames_per_trajectory=4, radius=0.15)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """``data_dir`` holding ``Water-3D/{train,valid,test}.h5`` from the JAX
    package's generator."""
    root = tmp_path_factory.mktemp("sim")
    jsim.make_synthetic_simulation_h5(str(root / "Water-3D"), n_trajectories=N_TRAJ,
                                      n_particles=N_PART, n_frames=N_FRAMES, seed=3)
    return str(root)


def _protocol(seed, n_samples):
    rng = np.random.default_rng(seed)
    hi = N_FRAMES - 15 - 2
    return dict(frames={f"traj_{i}": rng.integers(0, hi + 1, size=4).tolist()
                        for i in range(N_TRAJ)},
                rot_deg=rng.integers(0, 361, size=n_samples).tolist(),
                order=rng.permutation(n_samples).tolist())


def _assert_same_graphs(jds, pds):
    assert jds.spec.max_nodes == pds.spec.max_nodes
    assert jds.spec.max_edges == pds.spec.max_edges
    assert len(jds) == len(pds)
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_synthetic_trajectories_match_the_jax_file(trio, tmp_path):
    ours = psim.synthetic_trajectories(N_TRAJ, N_PART, N_FRAMES, seed=3)
    psim.make_synthetic_simulation_h5(str(tmp_path), N_TRAJ, N_PART, N_FRAMES, seed=3)
    for split in psim.SPLITS:
        with h5py.File(f"{trio}/Water-3D/{split}.h5", "r") as jf, \
                h5py.File(f"{tmp_path}/{split}.h5", "r") as pf:
            assert list(jf.keys()) == list(pf.keys()) == [k for k, _, _ in ours[split]]
            for key, ptype, pos in ours[split]:
                for f in (jf, pf):
                    np.testing.assert_array_equal(np.asarray(f[key]["particle_type"]),
                                                  ptype[:, 0])
                    np.testing.assert_array_equal(np.asarray(f[key]["position"]), pos)


@pytest.mark.parametrize("partition", ["train", "valid", "test"])
@pytest.mark.parametrize("protocol", [False, True])
def test_splits_are_the_jax_arrays_exactly(trio, partition, protocol):
    opts = dict(OPTS, protocol=_protocol(11, 7) if protocol else None)
    jds = jsim.SimulationDataset(trio, "Water-3D", partition=partition, **opts)
    pds = psim.SimulationDataset(trio, "Water-3D", partition=partition, device="cpu", **opts)
    _assert_same_graphs(jds, pds)
    # and so is a batch of them
    jb, pb = jds.collate([3, 0, 5]), pds.collate([3, 0, 5])
    for f in ("node_feat", "coord", "vel", "coord_target", "node_mask", "graph_id", "dst",
              "src", "edge_attr", "edge_mask", "dst_count", "loc_mean", "node_attr"):
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def test_datasets_from_memory_equal_the_h5_datasets(trio):
    trajectories = psim.synthetic_trajectories(N_TRAJ, N_PART, N_FRAMES, seed=3)
    for split in psim.SPLITS:
        from_file = psim.SimulationDataset(trio, partition=split, device="cpu", **OPTS)
        in_memory = psim.SimulationDataset.from_trajectories(
            trajectories[split], split, device="cpu", **OPTS)
        _assert_same_graphs(from_file, in_memory)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_batches_gives_the_jax_order(trio, shuffle, prefetch, drop_last):
    jds = jsim.SimulationDataset(trio, partition="train", **OPTS)
    pds = psim.SimulationDataset(trio, partition="train", device="cpu", **OPTS)
    rngs = [np.random.default_rng(4) if shuffle else None for _ in range(2)]
    got = [b.coord.numpy() for b in pds.iter_batches(2, rng=rngs[0], drop_last=drop_last,
                                                      prefetch=prefetch)]
    want = [np.asarray(b.coord) for b in jds.iter_batches(2, rng=rngs[1],
                                                           drop_last=drop_last, prefetch=0)]
    assert len(got) == len(want) == pds.num_batches(2, drop_last) == (3 if drop_last else 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(pds.collate_seconds) == len(got)


def test_collate_cache_keeps_eval_batches():
    ds = psim.SimulationDataset.from_trajectories(
        psim.synthetic_trajectories(1, 30, 30, seed=1)["valid"], "valid", device="cpu",
        virtual_channels=3, max_samples=4, seed=2)
    ds.enable_collate_cache()
    first = list(ds.iter_batches(2, prefetch=2))
    again = list(ds.iter_batches(2, prefetch=2))
    assert len(first) == 2 and all(a is b for a, b in zip(first, again))
    assert len(ds.collate_seconds) == 2          # collated once each
    assert ds.collate([0, 1]) is first[0]


def test_dataset_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trajectories = psim.synthetic_trajectories(1, 20, 30, seed=1)["train"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psim.SimulationDataset.from_trajectories(trajectories, max_samples=2)
    with pytest.raises(ValueError, match="n_graphs=1"):
        ds = psim.SimulationDataset.from_trajectories(trajectories, max_samples=2,
                                                      device="cpu")
        GraphDataset(ds.graphs, ds.batch_spec(2), device="cpu")


def test_the_port_imports_h5py_only_to_read_or_write_a_file():
    # a GPU machine need not have h5py: importing every module of the port,
    # and chip_smoke, must not need it
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(repo)!r})
        import fastegnn_tpu_torch
        for m in pkgutil.walk_packages(fastegnn_tpu_torch.__path__, "fastegnn_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        assert "h5py" not in sys.modules
        from fastegnn_tpu_torch.data.simulation import synthetic_trajectories
        synthetic_trajectories(1, 5, 20)
        assert "h5py" not in sys.modules
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(repo))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
