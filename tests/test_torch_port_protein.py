"""The port's protein dataset against the JAX package.

The same ``.npz`` goes through ``fastegnn_tpu.data.protein`` and
``fastegnn_tpu_torch.data.protein``: the synthetic fixture's arrays, every
split's padded graphs (the test split randomly rotated and translated) and
their batches, ``virtual_fibonacci`` included, must be the same exactly.
``preprocess_adk`` runs against recorded stand-ins of MDAnalysis, as the
JAX package's test runs it.
"""

import sys
import types

import numpy as np
import pytest

from fastegnn_tpu.data import protein as jprot
from fastegnn_tpu_torch.data import protein as pprot
from fastegnn_tpu_torch.ops.rotation import random_rotation

SPLITS = ("train", "valid", "test")
# 50 atoms with ~21 contacts each within 10 Angstrom; 60 frames and
# delta_frame 5: 54 usable frames, 32 / 10 / 11 samples
OPTS = dict(delta_frame=5, seed=3)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("prot") / "adk.npz"
    jprot.make_synthetic_protein_npz(str(path), n_atoms=50, n_frames=60, seed=0)
    return str(path)


def test_synthetic_npz_is_the_jax_npz(npz, tmp_path):
    pprot.make_synthetic_protein_npz(str(tmp_path / "p.npz"), n_atoms=50, n_frames=60, seed=0)
    a, b = np.load(npz), np.load(tmp_path / "p.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(
        ["positions", "velocities", "charges", "bonds", "bond_lengths", "dimensions"])
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fibonacci_sphere_is_the_jax_one():
    for c in (1, 3, 8):
        np.testing.assert_array_equal(pprot._fibonacci_sphere(c), jprot._fibonacci_sphere(c))
    np.testing.assert_allclose(np.linalg.norm(pprot._fibonacci_sphere(8), axis=1), 1.0,
                               atol=1e-6)


# the JAX signature's options: no test rotation (the translation draw moves
# up), no test translation, and a narrower contact graph padded to a given
# edge capacity (50 x 49, every ordered pair)
OPTIONS = {"defaults": {}, "no_rot": dict(test_rot=False), "no_trans": dict(test_trans=False),
           "cutoff_8_max_edges": dict(contact_cutoff=8.0, max_edges=50 * 49)}


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("partition", SPLITS)
@pytest.mark.parametrize("channels,cutoff_rate", [(3, 0.5), (1, 0.0)])
def test_splits_are_the_jax_arrays_exactly(npz, partition, channels, cutoff_rate, options):
    opts = dict(OPTS, partition=partition, virtual_channels=channels,
                cutoff_rate=cutoff_rate, max_samples=6, **OPTIONS[options])
    jds = jprot.ProteinDataset(npz, **opts)
    pds = pprot.ProteinDataset(npz, device="cpu", **opts)
    assert jds.spec.max_nodes == pds.spec.max_nodes == 50
    assert jds.spec.max_edges == pds.spec.max_edges
    if "max_edges" in opts:
        assert pds.spec.max_edges == opts["max_edges"]
    assert len(jds) == len(pds) == 6
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys()
        assert ("virtual_fibonacci" in b) == (channels > 1)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    jb, pb = jds.collate([4, 0, 2]), pds.collate([4, 0, 2])
    for f in ("node_feat", "coord", "vel", "coord_target", "node_mask", "graph_id", "dst",
              "src", "edge_attr", "edge_mask", "dst_count", "loc_mean", "node_attr"):
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
    if channels > 1:
        assert tuple(pb.virtual_fibonacci.shape) == (3, 3, channels)
        np.testing.assert_array_equal(pb.virtual_fibonacci.numpy(),
                                      np.asarray(jb.virtual_fibonacci))
    else:
        assert pb.virtual_fibonacci is None and jb.virtual_fibonacci is None
    bonds, lengths = pds.bond_edges()
    jbonds, jlengths = jds.bond_edges()
    np.testing.assert_array_equal(bonds, jbonds)
    np.testing.assert_array_equal(lengths, jlengths)


def test_the_test_split_is_rotated_and_translated(npz):
    """Each test graph is its frame moved rigidly by the rotation and the
    translation (half the box, times a normal draw) drawn from ``seed`` in
    turn."""
    data = np.load(npz)
    pos, vel, dims = data["positions"], data["velocities"], data["dimensions"]
    ds = pprot.ProteinDataset(npz, "test", device="cpu", **OPTS)
    rng = np.random.default_rng(OPTS["seed"])
    t0 = 32 + 10   # the first test frame, after 32 train and 10 valid samples
    for i, g in enumerate(ds.graphs):
        t = t0 + i
        R = random_rotation(rng).astype(np.float32)
        tr = (rng.standard_normal(3) * dims / 2).astype(np.float32)
        np.testing.assert_array_equal(g["coord"], pos[t] @ R + tr)
        np.testing.assert_array_equal(g["coord_target"], pos[t + OPTS["delta_frame"]] @ R + tr)
        np.testing.assert_array_equal(g["vel"], vel[t] @ R)
        np.testing.assert_allclose(_distances(g["coord"]), _distances(pos[t]), atol=1e-3)
        assert np.abs(g["coord"] - pos[t]).max() > 1.0


def _distances(x):
    return np.linalg.norm(x[..., :, None, :] - x[..., None, :, :], axis=-1)


def test_splits_are_disjoint(npz):
    """Every sample's input frame, found in the trajectory by its distances
    (the test split's frames are moved rigidly), lies in one split only, and
    the split sizes are the reference's 2481/827/863 scaled."""
    d_all = _distances(np.load(npz)["positions"])
    frames = {}
    for part in SPLITS:
        frames[part] = []
        for g in pprot.ProteinDataset(npz, part, device="cpu", **OPTS).graphs:
            gap = np.abs(d_all - _distances(g["coord"])[None]).max(axis=(1, 2))
            t = int(gap.argmin())
            assert gap[t] < 1e-3 and np.partition(gap, 1)[1] > 1e-2
            frames[part].append(t)
    assert [len(frames[p]) for p in SPLITS] == [32, 10, 11]
    sets = [set(frames[p]) for p in SPLITS]
    assert sum(len(s) for s in sets) == len(set.union(*sets)) == 53
    assert max(frames["train"]) < min(frames["valid"]) <= max(frames["valid"]) < min(
        frames["test"])


def test_local_edges_raise(npz):
    """``with_local_edges`` once raised; its bond batches are now the JAX
    ones (the covalent bonds with ``[topology length, frame-0 length]``
    attributes), and a batch without them still raises in EGHN."""
    from fastegnn_tpu_torch.models.eghn import EGHN

    opts = dict(OPTS, partition="test", virtual_channels=3, max_samples=3,
                with_local_edges=True)
    jds = jprot.ProteinDataset(npz, **opts)
    pds = pprot.ProteinDataset(npz, device="cpu", **opts)
    assert jds.spec.max_local_edges == pds.spec.max_local_edges == 49
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys() and "local_edge_attr" in b
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    jb, pb = jds.collate([2, 0]), pds.collate([2, 0])
    for f in ("local_dst", "local_src", "local_edge_attr", "local_edge_mask"):
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
    bonds, lengths = pds.bond_edges()
    np.testing.assert_array_equal(pb.local_edge_attr[:49, 0].numpy(), lengths)
    np.testing.assert_array_equal(pb.local_dst[49:].numpy() - 50, bonds[:, 0])
    model = EGHN(2, 2, hidden=16, n_cluster=3, layer_per_block=1, layer_pooling=1,
                 device="cpu")
    assert np.isfinite(model(pb)[0].detach().numpy()).all()
    with pytest.raises(ValueError, match="with_local_edges=True"):
        model(pprot.ProteinDataset(npz, device="cpu", **dict(opts, with_local_edges=False))
              .collate([0]))


def test_preprocess_adk_needs_mdanalysis(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "MDAnalysis", None)
    with pytest.raises(ImportError, match="MDAnalysis and MDAnalysisData"):
        pprot.preprocess_adk(str(tmp_path), str(tmp_path / "adk.npz"))


def test_preprocess_adk_runs_via_recorded_fixture(tmp_path, monkeypatch):
    """``preprocess_adk`` itself against stand-ins of MDAnalysis and
    MDAnalysisData with the API it touches (reference
    ``datasets/protein/dataset.py:82-129``), as
    ``tests/test_datasets.py::test_preprocess_adk_runs_via_recorded_fixture``
    runs the JAX package's; frame 3 fails twice to run the retry loop.  The
    two packages' ``.npz`` files hold the same arrays."""
    rng = np.random.default_rng(5)
    n_atoms, n_frames = 24, 12
    pos = rng.normal(size=(n_frames, n_atoms, 3)).astype(np.float32) * 5.0
    charges_all = rng.normal(size=(n_atoms,)).astype(np.float32)
    backbone_ix = np.arange(0, n_atoms, 2)
    bonds = np.concatenate([
        np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)], 1),
        np.stack([backbone_ix[:-1], backbone_ix[1:]], 1)]).astype(np.int64)

    class _TS:
        def __init__(self, t):
            self.positions = pos[t]
            self.has_velocities = False
            self.velocities = np.zeros_like(pos[t])
            self.dimensions = np.array([60.0, 60.0, 60.0, 90, 90, 90])

    class _Traj:
        def __init__(self):
            self._fail = {3: 2}

        def __len__(self):
            return n_frames

        def __getitem__(self, t):
            if self._fail.get(t, 0) > 0:
                self._fail[t] -= 1
                raise OSError("transient DCD read failure")
            return _TS(t)

    class _AtomGroup:
        def __init__(self, ix):
            self.ix = np.asarray(ix)

        def __getitem__(self, ix):
            return _AtomGroup(np.asarray(ix))

        @property
        def charges(self):
            return charges_all[self.ix]

        @property
        def n_atoms(self):
            return n_atoms

    class _Universe:
        def __init__(self, topology, trajectory):
            assert topology == "adk.psf" and trajectory == "adk.dcd"
            self.atoms = _AtomGroup(np.arange(n_atoms))
            self.trajectory = _Traj()
            self.bonds = types.SimpleNamespace(indices=bonds)

        def select_atoms(self, sel):
            assert sel == "backbone"
            return _AtomGroup(backbone_ix)

    fake_mda = types.ModuleType("MDAnalysis")
    fake_mda.Universe = _Universe
    fake_mdad = types.ModuleType("MDAnalysisData")
    fake_mdad.datasets = types.SimpleNamespace(
        fetch_adk_equilibrium=lambda data_home: types.SimpleNamespace(
            topology="adk.psf", trajectory="adk.dcd"))
    monkeypatch.setitem(sys.modules, "MDAnalysis", fake_mda)
    monkeypatch.setitem(sys.modules, "MDAnalysisData", fake_mdad)

    out = tmp_path / "adk.npz"
    pprot.preprocess_adk(str(tmp_path), str(out), backbone=True)
    jprot.preprocess_adk(str(tmp_path), str(tmp_path / "jax.npz"), backbone=True)

    data, want = np.load(out), np.load(tmp_path / "jax.npz")
    assert sorted(data.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(data[k], want[k], err_msg=k)
    nb = backbone_ix.size
    assert data["positions"].shape == data["velocities"].shape == (n_frames, nb, 3)
    np.testing.assert_allclose(   # finite-difference velocities (none recorded)
        data["velocities"][:-1], data["positions"][1:] - data["positions"][:-1])
    np.testing.assert_allclose(data["charges"][:, 0], charges_all[backbone_ix])
    b = data["bonds"]
    assert b.min() >= 0 and b.max() < nb
    np.testing.assert_allclose(
        data["bond_lengths"],
        np.linalg.norm(data["positions"][0][b[:, 0]] - data["positions"][0][b[:, 1]], axis=1),
        rtol=1e-6)
    # and the dataset reads the file end to end
    ds = pprot.ProteinDataset(str(out), partition="train", device="cpu", virtual_channels=3,
                              delta_frame=2)
    assert len(ds) >= 1
    batch = ds.collate([0])
    assert tuple(batch.coord.shape) == (nb, 3)
    assert tuple(batch.virtual_fibonacci.shape) == (1, 3, 3)
    np.testing.assert_array_equal(ds.bond_edges()[0], b)
