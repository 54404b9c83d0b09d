"""The port's model registry (counterpart of ``fastegnn_tpu/models/__init__.py``).

``MODEL_REGISTRY`` maps the reference CLI's ``--model`` names to the port's
constructors, ``MMD_MODELS`` is the Fast* family that trains with the MMD
virtual-node loss (reference ``utils/train.py:111-112``) and
``MODEL_KWARGS`` the keyword arguments each constructor takes beside
``node_feat_dim``, ``edge_attr_dim``, ``device`` and ``generator`` (the
JAX package's sets).  ``TRIPLET_MODELS`` read the batch's triplet table
(their datasets are wrapped in ``TripletDataset``).  Every name of the JAX
registry has its port.  :func:`get_model` drops the keyword arguments a
model does not take, as the JAX package's does: a model without
``compute_dtype`` is built in float32 whatever dtype is asked for
(:func:`computes_in_float32_only` tells the caller, which the CLIs print).
The options no CLI sets (``residual``, ``node_attr_dim``) are constructor
arguments only, as in the JAX package.
"""

from __future__ import annotations

import torch

from fastegnn_tpu_torch.models.basic import EGNN, GNN, FullMLP, LinearDynamics, RFVel
from fastegnn_tpu_torch.models.dimenet import DimeNet, DimeNetPlusPlus, TripletDataset
from fastegnn_tpu_torch.models.eghn import EGHN
from fastegnn_tpu_torch.models.fast_egnn import FastEGNN
from fastegnn_tpu_torch.models.fast_rf import FastRF
from fastegnn_tpu_torch.models.gvp import GVPNet
from fastegnn_tpu_torch.models.schnet import FastSchNet, SchNet
from fastegnn_tpu_torch.models.tfn import FastTFN, OurDynamics
from fastegnn_tpu_torch.models.vnegnn import VNEGNN

MODEL_REGISTRY = {
    "FastEGNN": FastEGNN,
    "FastRF": FastRF,
    "FastSchNet": FastSchNet,
    "FastTFN": FastTFN,
    # the reference CLI's "TFN" builds the OurDynamics(model="tfn") wrapper
    # (main_nbody.py:117-120)
    "TFN": OurDynamics,
    "VNEGNN": VNEGNN,
    # reads the bond edges from the batch (the protein dataset's
    # with_local_edges); returns (x, h, cut_loss)
    "EGHN": EGHN,
    "EGNN": EGNN,
    "GNN": GNN,
    "Linear": LinearDynamics,
    "RF": RFVel,
    # takes an array, not a graph batch: no training CLI feeds it
    "MLP": FullMLP,
    "SchNet": SchNet,
    # returns (coord_pred, (s, V))
    "GVP": GVPNet,
    # read the batch's triplet table: their datasets are wrapped in
    # TripletDataset (cli/common.py::run_training does it)
    "DimeNet": DimeNet,
    "DimeNet++": DimeNetPlusPlus,
}
TRIPLET_MODELS = ("DimeNet", "DimeNet++")

MMD_MODELS = {"FastEGNN", "FastRF", "FastTFN", "FastSchNet"}

_GEOMETRIC_KW = {"hidden", "n_layers", "attention", "normalize", "tanh"}
MODEL_KWARGS = {
    "FastEGNN": _GEOMETRIC_KW | {"virtual_channels", "gravity", "compute_dtype"},
    "FastRF": _GEOMETRIC_KW | {"virtual_channels", "gravity"},
    # FastSchNet and FastTFN take `normalize` and do not use it, as in JAX
    "FastSchNet": _GEOMETRIC_KW | {"virtual_channels", "gravity"},
    "FastTFN": _GEOMETRIC_KW | {"virtual_channels", "gravity"},
    # the CLIs pass n_layers only: nf=32, num_degrees=2, div=1
    "TFN": {"nf", "n_layers", "num_degrees", "div"},
    # no gravity term
    "VNEGNN": _GEOMETRIC_KW | {"virtual_channels"},
    "EGHN": {"hidden", "n_cluster", "layer_per_block", "layer_pooling", "layer_decoder"},
    "EGNN": {"hidden", "n_layers"},
    "GNN": {"hidden", "n_layers"},
    "Linear": set(),
    "RF": {"hidden", "n_layers"},
    "MLP": {"hidden", "n_layers"},
    # the JAX CLI fixes SchNet at 16 interactions whatever --num_layer says
    # (main_nbody.py:129)
    "SchNet": {"hidden", "num_interactions", "num_filters", "num_gaussians", "cutoff"},
    "GVP": {"n_layers", "node_h_dim", "edge_h_dim", "drop_rate"},
    # the JAX CLI sets num_blocks = --num_layer (main_nbody.py:124-127)
    "DimeNet": {"hidden", "num_blocks"},
    "DimeNet++": {"hidden", "num_blocks"},
}


def get_model(name: str, node_feat_dim: int, edge_attr_dim: int, device=None,
              generator=None, **kwargs) -> torch.nn.Module:
    """The model ``name`` built with the keyword arguments it takes."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    allowed = MODEL_KWARGS[name]
    kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    return MODEL_REGISTRY[name](node_feat_dim, edge_attr_dim, device=device,
                                generator=generator, **kwargs)


def computes_in_float32_only(name: str, compute_dtype) -> bool:
    """Whether :func:`get_model` builds ``name`` in float32 although
    ``compute_dtype`` asks for another dtype: the model has no such path."""
    return compute_dtype not in (None, torch.float32) and "compute_dtype" not in MODEL_KWARGS[name]


__all__ = ["DimeNet", "DimeNetPlusPlus", "EGHN", "EGNN", "GNN", "GVPNet", "FastEGNN", "FastRF",
           "FastSchNet", "FastTFN", "FullMLP", "LinearDynamics", "OurDynamics", "RFVel",
           "SchNet", "TripletDataset", "VNEGNN", "MODEL_REGISTRY", "MMD_MODELS",
           "MODEL_KWARGS", "TRIPLET_MODELS", "computes_in_float32_only", "get_model"]
