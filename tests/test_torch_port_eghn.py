"""The port's EGHN, its bond-edge batches and its protein training against
the JAX package.

The protein fixture is ``make_synthetic_protein_npz(n_atoms=50,
n_frames=60)``, whose bonds form a chain in one direction; a second input
is 3 random graphs of 14 nodes with random bond lists of different
lengths (so padded bond slots) relabelled in Morton order.  The models are
held on batches without padded nodes, as the protein dataset's are: on a
padded node every vector of EGHN's decoder is zero, and the JAX
package's gradient of their normalised Gram matrix is NaN there (torch's
norm has a zero gradient at zero).  Weights cross
through the reference state-dict layout: JAX params ->
``state_dict_from_eghn_params`` -> port, and back through
``params_from_eghn_state_dict``.  EGHN here: H=32, 5 clusters, 2 layers
per block, 2 pooling layers, a decoder of 1 or 2 layers, f32.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import fastegnn_tpu.train as jtrain_module
from fastegnn_tpu.cli import protein as jcli
from fastegnn_tpu.cli.common import run_training as jrun_training
from fastegnn_tpu.data import protein as jprot
from fastegnn_tpu.graph import GraphSpec as JSpec, batch_graphs as jbatch, pad_graph as jpad
from fastegnn_tpu.models import EGHN as JEGHN
from fastegnn_tpu.train import torch_adam as jadam
from fastegnn_tpu.train.step import make_loss_fn as jloss_fn
from fastegnn_tpu.utils.torch_import import params_from_eghn_state_dict
from fastegnn_tpu_torch import models as pmodels
from fastegnn_tpu_torch.cli import protein as pcli
from fastegnn_tpu_torch.cli.common import run_training
from fastegnn_tpu_torch.data import protein as pprot
from fastegnn_tpu_torch.graph import GraphSpec, batch_graphs, pad_graph
from fastegnn_tpu_torch.models.eghn import EGHN
from fastegnn_tpu_torch.train.loss import masked_mse
from fastegnn_tpu_torch.train.optim import torch_adam
from fastegnn_tpu_torch.train.step import make_train_step
from fastegnn_tpu_torch.utils.weights import state_dict_from_eghn_params

from helpers import random_raw_graph
from test_torch_port_nbody import check_one_train_step, leaf_gaps

OPTS = dict(delta_frame=5, seed=3, virtual_channels=3, cutoff_rate=0.5, with_local_edges=True)
KW = dict(hidden=32, n_cluster=5, layer_per_block=2, layer_pooling=2)
LOCAL = ("local_dst", "local_src", "local_edge_attr", "local_edge_mask")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("prot") / "adk.npz"
    jprot.make_synthetic_protein_npz(str(path), n_atoms=50, n_frames=60, seed=0)
    return str(path)


def _bond_raws(seed=2, flip=False, sizes=(14, 14, 14)):
    """3 random graphs of ``sizes`` nodes, each with 8-20 random bonds of
    ``[length, length]`` attributes; ``flip`` swaps every bond's ends."""
    rng = np.random.default_rng(seed)
    raws = []
    for n in sizes:
        r = random_raw_graph(rng, n, cutoff_rate=0.3)
        nb = int(rng.integers(8, 21))
        d, s = rng.integers(0, n, nb), rng.integers(0, n, nb)
        s = np.where(s == d, (s + 1) % n, s)
        if flip:
            d, s = s, d
        length = np.linalg.norm(r["coord"][d] - r["coord"][s], axis=1, keepdims=True)
        r.update(local_dst=d.astype(np.int32), local_src=s.astype(np.int32),
                 local_edge_attr=np.concatenate([length, length], 1).astype(np.float32))
        raws.append(r)
    return raws


def _bond_batches(raws):
    kw = dict(max_nodes=14, max_edges=14 * 13, n_graphs=3, edge_attr_dim=2,
              max_local_edges=20)
    js, ps = JSpec(**kw), GraphSpec(**kw)
    return (jbatch([jpad(js, spatial_sort=True, **r) for r in raws], js),
            batch_graphs([pad_graph(ps, spatial_sort=True, **r) for r in raws], ps,
                         device="cpu"))


def _check_local(jb, pb):
    for f in LOCAL:
        a, b = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
    # the perms: each a stable argsort of the real bonds by dst / by src,
    # with the row pointer of that order
    mask = pb.local_edge_mask.numpy()
    for ids, perm, rowptr in ((pb.local_dst, pb.local_perm, pb.local_rowptr),
                              (pb.local_src, pb.local_src_perm, pb.local_src_rowptr)):
        ids = ids.numpy()
        real = np.flatnonzero(mask)
        np.testing.assert_array_equal(perm.numpy(), real[np.argsort(ids[real], kind="stable")])
        np.testing.assert_array_equal(rowptr.numpy(), np.searchsorted(
            ids[perm.numpy()], np.arange(pb.num_nodes + 1)))


@pytest.mark.parametrize("partition", ["train", "valid", "test"])
def test_bond_batches_are_the_jax_arrays_exactly(npz, partition):
    jds = jprot.ProteinDataset(npz, partition=partition, max_samples=4, **OPTS)
    pds = pprot.ProteinDataset(npz, partition=partition, device="cpu", max_samples=4, **OPTS)
    assert jds.spec.max_local_edges == pds.spec.max_local_edges == 49
    for a, b in zip(jds.graphs, pds.graphs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    _check_local(jds.collate([1, 0]), pds.collate([1, 0]))


def test_padded_and_relabelled_bonds_match_jax():
    jb, pb = _bond_batches(_bond_raws(sizes=(14, 10, 12)))
    _check_local(jb, pb)
    assert not pb.local_edge_mask.all()          # padded bond slots
    assert not pb.node_mask.all()                # and padded nodes
    assert pb.local_perm.shape[0] == int(pb.local_edge_mask.sum())


def _protein_batches(npz):
    jds = jprot.ProteinDataset(npz, partition="train", max_samples=3, **OPTS)
    pds = pprot.ProteinDataset(npz, partition="train", device="cpu", max_samples=3, **OPTS)
    return jds.collate([0, 1, 2]), pds.collate([0, 1, 2])


def _apply(jm, params, jb):
    return jm.apply({"params": params}, jb, jb.local_dst, jb.local_src, jb.local_edge_attr,
                    jb.local_edge_mask)


def _to_jax(sd, layer_decoder, layer_per_block=2, layer_pooling=2):
    return params_from_eghn_state_dict(sd, layer_per_block=layer_per_block,
                                       layer_pooling=layer_pooling, layer_decoder=layer_decoder)


def _models(layer_decoder):
    """The JAX model, its params and the port model with them.  The params
    are a port init through the JAX importer (the JAX package's eager init
    of EGHN takes ~17 s here); the CLI test below carries a JAX init over."""
    jm = JEGHN(layer_decoder=layer_decoder, **KW)
    first = EGHN(2, 2, layer_decoder=layer_decoder, device="cpu",
                 generator=torch.Generator().manual_seed(0), **KW)
    params = _to_jax({k: v.detach().numpy() for k, v in first.state_dict().items()},
                     layer_decoder)
    pm = EGHN(2, 2, layer_decoder=layer_decoder, device="cpu", **KW)
    pm.load_state_dict(state_dict_from_eghn_params(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module", params=[("protein", 2), ("protein", 1), ("bonds", 2)])
def case(request, npz):
    """The JAX forward, and the JAX train step's loss and parameter
    gradients with the JAX CLI's EGHN prediction (the MSE of ``x_out``, the
    cut loss left out, no MMD term); and the port model with the same
    weights; on the protein batch (decoder of 2 or 1 layers) and on the
    random bonds with padded slots."""
    data, layer_decoder = request.param
    jb, pb = _protein_batches(npz) if data == "protein" else _bond_batches(_bond_raws())
    jm, params, pm = _models(layer_decoder)
    loss_fn = jloss_fn(jm, 1.0, 0.5, 3, False, False, apply_fn=lambda p, g: _apply(jm, p, g)[0])

    def jloss(p):
        total, metrics = loss_fn(p, jb, np.zeros(2, np.uint32))
        return total, (metrics, _apply(jm, p, jb))

    (total, ((mse, mmd), out)), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(jb=jb, pb=pb, pm=pm, params=params, layer_decoder=layer_decoder, gj=gj,
                out=[np.asarray(o) for o in out],
                metrics=dict(loss=float(total), mse=float(mse), mmd=float(mmd)))


def _same_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_weights_round_trip_through_the_jax_importer_bit_for_bit(case):
    ld = case["layer_decoder"]
    sd = {k: v.detach().numpy() for k, v in case["pm"].state_dict().items()}
    _same_trees(_to_jax(sd, ld), case["params"])
    fresh = EGHN(2, 2, layer_decoder=ld, device="cpu", generator=torch.Generator().manual_seed(1),
                 **KW)
    sd = {k: v.detach().numpy() for k, v in fresh.state_dict().items()}
    back = state_dict_from_eghn_params(_to_jax(sd, ld))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def _forward_gap(pm, pb, want, mask):
    """The largest gap of ``(x_out, h_out, cut_loss)`` over each output's
    largest value."""
    with torch.no_grad():
        got = pm(pb)
    gaps = []
    for a, b in zip(got, want):
        a = a.numpy()
        if a.ndim:
            a, b = a[mask], b[mask]
        gaps.append(float(np.abs(a - b).max() / np.abs(b).max()))
    return max(gaps)


# 1e-5 of each output's largest value (measured: at most 2.3e-7)
def test_forward_matches_jax(case):
    mask = np.asarray(case["jb"].node_mask)
    assert _forward_gap(case["pm"], case["pb"], case["out"], mask) <= 1e-5


# 1e-4 of each leaf's floored scale (measured: at most 4.4e-6)
def test_param_gradients_of_the_loss_match_jax(case):
    pm, pb = case["pm"], case["pb"]
    pm.zero_grad()
    masked_mse(pm(pb)[0], pb.coord_target, pb.node_mask).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    gp = _to_jax(grads, case["layer_decoder"])
    assert jax.tree.structure(gp) == jax.tree.structure(case["gj"])
    gaps, _ = leaf_gaps(gp, case["gj"])
    assert max(gaps) <= 1e-4, gaps


def test_bond_sums_read_the_bonds_through_their_perms(npz):
    # the bond sums do not depend on the order the perm lists a dst's bonds
    # in; a batch with every bond's ends swapped is another input, whose
    # output is off by more than the forward test's 1e-5 (the port's output
    # on the unswapped batch is the JAX one: test_forward_matches_jax)
    _, pb = _bond_batches(_bond_raws())
    _, _, pm = _models(2)
    with torch.no_grad():
        want = [o.numpy() for o in pm(pb)]
    mask = pb.node_mask.numpy()
    rng = np.random.default_rng(0)
    shuffled = {}
    for key, rp in (("local_perm", pb.local_rowptr), ("local_src_perm", pb.local_src_rowptr)):
        perm, rp = getattr(pb, key).numpy().copy(), rp.numpy()
        for lo, hi in zip(rp[:-1], rp[1:]):
            perm[lo:hi] = rng.permutation(perm[lo:hi])
        shuffled[key] = torch.tensor(perm)
    assert not torch.equal(shuffled["local_perm"], pb.local_perm)
    assert _forward_gap(pm, dataclasses.replace(pb, **shuffled), want, mask) <= 1e-6
    # measured: 2.6e-4
    _, flipped = _bond_batches(_bond_raws(flip=True))
    assert _forward_gap(pm, flipped, want, mask) > 1e-5
    _, ppb = _protein_batches(npz)
    with pytest.raises(ValueError, match="with_local_edges=True"):
        pm(dataclasses.replace(ppb, local_dst=None))


# On the MSE alone, the cut loss left out, as the JAX CLI trains EGHN.
# Measured: gradients at most 4.4e-6 of their floored scale, post-Adam
# parameters 7.5e-9
def test_one_train_step_matches_jax(case):
    params, ld = case["params"], case["layer_decoder"]
    tx = jadam(5e-4, 1e-12)
    new_j = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        case["gj"], params)
    pm = EGHN(2, 2, layer_decoder=ld, device="cpu", **KW)
    pm.load_state_dict(state_dict_from_eghn_params(params), strict=True)
    opt = torch_adam(pm.parameters(), 5e-4, 1e-12)
    mp = make_train_step(pm, opt, sigma=1.0, weight=0.5, sample=3, use_mmd=False)(case["pb"])
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in pm.named_parameters()}
    check_one_train_step(dict(
        jax=case["metrics"], port={k: float(v) for k, v in mp.items()}, gj=case["gj"],
        gp=_to_jax(grads, ld), new_j=new_j,
        new_p=_to_jax({k: v.detach().numpy() for k, v in pm.state_dict().items()}, ld)))


# The logged MSEs are ~55 (the synthetic chain's coordinates in Angstrom,
# H=16).  Measured: every train, valid and test MSE within 1.4e-7
# relative; rtol 2e-4, the N-body CLI tests'
def test_cli_training_of_eghn_tracks_the_jax_cli(monkeypatch, tmp_path, npz):
    flags = ["--npz", npz, "--model", "EGHN", "--virtual_channel", "3", "--dim_hidden", "16",
             "--batch_size", "2", "--max_epochs", "2", "--test_interval", "1",
             "--max_train_samples", "4", "--max_test_samples", "2", "--delta_frame", "5",
             "--seed", "3", "--cutoff_rate", "0.5"]
    # the JAX CLI's run, its initial params caught where it hands them to train()
    seen = {}
    jtrain = jtrain_module.train

    def catch(model, state, *args, **kwargs):
        seen["params"] = jax.tree.map(np.asarray, state.params)
        assert kwargs["apply_fn"] is not None and not kwargs["use_mmd"]
        return jtrain(model, state, *args, **kwargs)

    monkeypatch.setattr(jtrain_module, "train", catch)
    jargs = jcli.build_parser().parse_args(flags + ["--log_directory", str(tmp_path / "j")])
    jsets = [jprot.ProteinDataset(npz, partition=s, virtual_channels=3, cutoff_rate=0.5,
                                  max_samples=m, delta_frame=5, seed=3, with_local_edges=True)
             for s, m in (("train", 4), ("valid", 2), ("test", 2))]
    jbest = jrun_training(jargs, *jsets, per_graph_sampling=False)

    build = pmodels.get_model

    def with_jax_weights(*args, **kwargs):
        m = build(*args, **kwargs)
        m.load_state_dict(state_dict_from_eghn_params(seen["params"]), strict=True)
        return m

    monkeypatch.setattr(pmodels, "get_model", with_jax_weights)
    # the JAX init at the CLI's depths, through the inverse and back
    _same_trees(_to_jax({k: v.numpy() for k, v in state_dict_from_eghn_params(
        seen["params"]).items()}, 2, layer_per_block=3, layer_pooling=4), seen["params"])
    args = pcli.build_parser().parse_args(flags + ["--platform", "cpu", "--log_directory",
                                                   str(tmp_path / "p")])
    run = run_training(args, *pcli.datasets(args, torch.device("cpu")), per_graph_sampling=False)
    jlog = jax_log(tmp_path / "j")
    assert run.step == 4 and run.log["epochs"] == jlog["epochs"] == [1, 2]
    np.testing.assert_allclose(run.log["loss_train"], jlog["loss_train"], rtol=2e-4)
    np.testing.assert_allclose(run.log["loss"], jlog["loss"], rtol=2e-4)
    np.testing.assert_allclose(run.best["loss_valid"], jbest["loss_valid"], rtol=2e-4)
    assert run.best["epoch_index"] == jbest["epoch_index"]


def jax_log(directory):
    """The per-epoch log the JAX CLI wrote (``[best, log]``)."""
    import json

    (path,) = directory.glob("*_loss_*.json")
    return json.loads(path.read_text())[1]
