"""Weights from the JAX package's params into the port.

Each function but five (named below) is the inverse of an importer of
``fastegnn_tpu/utils/torch_import.py``: :func:`state_dict_from_jax_params`
of ``params_from_reference_state_dict`` (FastEGNN),
:func:`state_dict_from_fastrf_params` of ``params_from_fastrf_state_dict``,
:func:`state_dict_from_fastschnet_params` of
``params_from_fastschnet_state_dict``,
:func:`state_dict_from_vnegnn_params` of ``params_from_vnegnn_state_dict``,
for the baselines ``state_dict_from_{egnn,gnn,rfvel,linear_dynamics,
egmn,eghn,schnet}_params`` of ``params_from_{...}_state_dict``, and
:func:`state_dict_from_gvpnet_params` / :func:`state_dict_from_dimenet_params`
of ``params_from_gvpnet_state_dict`` / ``params_from_dimenet_state_dict``.
The JAX package has no importer for FastTFN, FullMLP or the TFN family;
:func:`state_dict_from_fasttfn_params`, :func:`state_dict_from_fullmlp_params`,
:func:`state_dict_from_ourdynamics_params` (``--model TFN``),
:func:`state_dict_from_tfn_params` and
:func:`state_dict_from_se3transformer_params` map their trees as the others
do.
Each takes the JAX param tree as a nested dict of numpy arrays and returns
the port's ``state_dict`` in the reference PyTorch layout:

- flax kernels ``[in, out]`` become torch weights ``[out, in]``;
- ``virtual_node_feat`` goes from the JAX channel-major ``[1, C, H]`` back
  to the reference ``[1, H, C]``;
- the rows of ``node_mlp.lin0``'s kernel that read the flattened virtual
  messages go from the JAX ``[C, H]`` order back to the reference ``[H, C]``
  order (``torch_import.py:68-78``; FastEGNN, FastSchNet and FastTFN).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def _linear(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _head(params: Mapping) -> Dict[str, torch.Tensor]:
    """``embedding_in`` and ``virtual_node_feat`` ([1, C, H] -> [1, H, C])."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding_in", params["embedding_in"])
    sd["virtual_node_feat"] = _t(np.transpose(np.asarray(params["virtual_node_feat"]), (0, 2, 1)))
    return sd


def _layers(params: Mapping):
    n_layers = sum(1 for k in params if k.startswith("gcl_"))
    return [(f"gcl_{i}", params[f"gcl_{i}"]) for i in range(n_layers)]


def _two(sd: dict, prefix: str, p: Mapping, a: str, b: str) -> None:
    """A JAX two-linear block ``{a, b}`` -> the reference ``prefix.{0,2}``."""
    _linear(sd, f"{prefix}.0", p[a])
    _linear(sd, f"{prefix}.2", p[b])


def _node_mlp0(p: Mapping, H: int, C: int) -> dict:
    """``node_mlp.lin0`` with the virtual-message rows back in [H, C] order."""
    K = np.asarray(p["kernel"])                             # [in, out]
    virt = K[2 * H: 2 * H + C * H]
    virt = virt.reshape(C, H, -1).transpose(1, 0, 2).reshape(C * H, -1)
    return {"kernel": np.concatenate([K[:2 * H], virt, K[2 * H + C * H:]], axis=0),
            "bias": p["bias"]}


def _attention(sd: dict, g: str, p: Mapping) -> None:
    if "att_mlp" in p:
        _linear(sd, f"{g}.att_mlp.0", p["att_mlp"])
        _linear(sd, f"{g}.att_mlp_virtual.0", p["att_mlp_virtual"])


def state_dict_from_fastrf_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FastRF`` ``state_dict`` for a JAX ``FastRF`` param tree
    (layer count, gravity and attention read from the tree)."""
    sd = _head(params)
    for g, p in _layers(params):
        for name in ("edge_mlp", "edge_mlp_virtual", "coord_mlp_vel", "gravity_mlp"):
            if name in p:
                _two(sd, f"{g}.{name}", p[name], "lin0", "lin1")
        for name in ("coord_mlp_r", "coord_mlp_r_virtual", "coord_mlp_v_virtual"):
            _two(sd, f"{g}.{name}", p[name], "lin0", "head")
        _attention(sd, g, p)
    return sd


def state_dict_from_fastschnet_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FastSchNet`` ``state_dict`` for a JAX ``FastSchNet`` param
    tree (layer count, widths, gravity and attention read from the tree)."""
    vnf = np.asarray(params["virtual_node_feat"])          # [1, C, H]
    C, H = vnf.shape[1], vnf.shape[2]
    sd = _head(params)
    for g, p in _layers(params):
        for name in ("edge_mlp", "edge_mlp_virtual", "gravity_mlp", "node_mlp_virtual"):
            if name in p:
                _two(sd, f"{g}.{name}", p[name], "lin0", "lin1")
        for name in ("coord_mlp_r_virtual", "coord_mlp_v_virtual"):
            _two(sd, f"{g}.{name}", p[name], "lin0", "head")
        _linear(sd, f"{g}.node_mlp.0", _node_mlp0(p["node_mlp"]["lin0"], H, C))
        _linear(sd, f"{g}.node_mlp.2", p["node_mlp"]["lin1"])
        s, core = f"{g}.SchNetLayer", p["schnet_layer"]
        _linear(sd, f"{s}.coord_updates.0", core["coord_update_0"])
        block = core["interaction_0"]
        _two(sd, f"{s}.interactions.0.conv.nn", block["conv"], "nn0", "nn1")
        _linear(sd, f"{s}.interactions.0.conv.lin1", block["conv"]["lin1"])
        _linear(sd, f"{s}.interactions.0.conv.lin2", block["conv"]["lin2"])
        _linear(sd, f"{s}.interactions.0.lin", block["lin"])
        _attention(sd, g, p)
    return sd


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FastEGNN`` ``state_dict`` for a JAX ``FastEGNN`` param tree
    (layer count, widths, gravity and attention read from the tree)."""
    vnf = np.asarray(params["virtual_node_feat"])          # [1, C, H]
    C, H = vnf.shape[1], vnf.shape[2]
    sd = _head(params)
    for g, p in _layers(params):
        _linear(sd, f"{g}.edge_mlp.0", p["edge_mlp_lin0"])
        _linear(sd, f"{g}.edge_mlp.2", p["edge_mlp_lin1"])
        _linear(sd, f"{g}.coord_mlp_r.0", p["coord_mlp_r_lin0"])
        _linear(sd, f"{g}.coord_mlp_r.2", p["coord_mlp_r_head"])
        for name, (a, b) in {
            "edge_mlp_virtual": ("lin0", "lin1"),
            "coord_mlp_r_virtual": ("lin0", "head"),
            "coord_mlp_v_virtual": ("lin0", "head"),
            "coord_mlp_vel": ("lin0", "lin1"),
            "gravity_mlp": ("lin0", "lin1"),
            "node_mlp_virtual": ("lin0", "lin1"),
        }.items():
            if name in p:
                _two(sd, f"{g}.{name}", p[name], a, b)
        _linear(sd, f"{g}.node_mlp.0", _node_mlp0(p["node_mlp"]["lin0"], H, C))
        _linear(sd, f"{g}.node_mlp.2", p["node_mlp"]["lin1"])
        _attention(sd, g, p)
    return sd


def state_dict_from_vnegnn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``VNEGNN`` ``state_dict`` for a JAX ``VNEGNN`` param tree
    (layer count and attention read from the tree): per layer the cells
    ``A2A_i``, ``A2V_i`` and ``V2A_i``, each with ``edge_mlp``,
    ``coord_mlp``, ``node_mlp`` (and ``att_mlp``)."""
    sd = _head(params)
    n_layers = sum(1 for k in params if k.startswith("A2A_"))
    for i in range(n_layers):
        for cell in ("A2A", "A2V", "V2A"):
            g, p = f"{cell}_{i}", params[f"{cell}_{i}"]
            _two(sd, f"{g}.edge_mlp", p["edge_mlp"], "lin0", "lin1")
            _two(sd, f"{g}.coord_mlp", p["coord_mlp"], "lin0", "head")
            _two(sd, f"{g}.node_mlp", p["node_mlp"], "lin0", "lin1")
            if "att_mlp" in p:
                _linear(sd, f"{g}.att_mlp.0", p["att_mlp"])
    return sd


def state_dict_from_fasttfn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FastTFN`` ``state_dict`` for a JAX ``FastTFN`` param tree
    (layer count, widths, gravity and attention read from the tree).

    Outside ``tfn_layer`` the keys are the reference's (``gcl_i.edge_mlp``,
    ``edge_mlp_virtual``, ``coord_mlp_r_virtual``, ``coord_mlp_v_virtual``,
    ``node_mlp``, ``node_mlp_virtual``, ``gravity_mlp``, ``att_mlp*``,
    ``virtual_node_feat`` [1, H, C]).  The reference builds its TFN on DGL,
    whose layout is not in this repository, so ``tfn_layer`` keeps the JAX
    tree's names: ``gcl_i.tfn_layer.conv_out.core.pair_{di}_{do}.rp.{lin0,
    lin1, lin2}`` (torch ``Linear``), ``.rp.{bn0, bn1}`` (``LayerNorm``:
    flax's ``scale`` is torch's ``weight``) and ``.core.self_{d}`` [m_out,
    m_in], as it is."""
    vnf = np.asarray(params["virtual_node_feat"])          # [1, C, H]
    C, H = vnf.shape[1], vnf.shape[2]
    sd = _head(params)
    for g, p in _layers(params):
        for name in ("edge_mlp", "edge_mlp_virtual", "gravity_mlp", "node_mlp_virtual"):
            if name in p:
                _two(sd, f"{g}.{name}", p[name], "lin0", "lin1")
        for name in ("coord_mlp_r_virtual", "coord_mlp_v_virtual"):
            _two(sd, f"{g}.{name}", p[name], "lin0", "head")
        _linear(sd, f"{g}.node_mlp.0", _node_mlp0(p["node_mlp"]["lin0"], H, C))
        _linear(sd, f"{g}.node_mlp.2", p["node_mlp"]["lin1"])
        _attention(sd, g, p)
        sd.update(state_dict_from_gconv_params(p["tfn_layer"]["conv_out"],
                                               f"{g}.tfn_layer.conv_out."))
    return sd


def _flax_modules(sd: dict, prefix: str, tree: Mapping) -> None:
    """A flax module tree into ``sd`` under ``prefix``, where the port's
    modules carry the JAX names: a dict with a ``kernel`` is a ``Linear``,
    one with a ``scale`` a ``LayerNorm``, an array a parameter as it is, and
    any other dict a submodule."""
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if not isinstance(sub, Mapping):
            sd[key] = _t(sub)
        elif "kernel" in sub:
            _linear(sd, key, sub)
        elif "scale" in sub:
            sd[f"{key}.weight"] = _t(sub["scale"])
            sd[f"{key}.bias"] = _t(sub["bias"])
        else:
            _flax_modules(sd, f"{key}.", sub)


def state_dict_from_gconv_params(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port ``GConvSE3`` ``state_dict`` (keys after ``prefix``) for a
    JAX ``GConvSE3`` param tree: per pair ``core.pair_{di}_{do}.rp`` its
    linears and LayerNorms, and the self-interaction weights
    ``core.self_{d}``."""
    sd: Dict[str, torch.Tensor] = {}
    _flax_modules(sd, prefix, params)
    return sd


def state_dict_from_ourdynamics_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``OurDynamics`` (``--model TFN``) ``state_dict`` for a JAX
    ``OurDynamics`` param tree, of either kind: ``se3.conv_{i}`` /
    ``se3.norm_{i}`` / ``se3.conv_out`` (``model="tfn"``) or ``se3.res_{i}``
    (``v``, ``k``: partial convolutions; ``q.w_{d}``) / ``se3.norm_{i}`` /
    ``se3.conv_out`` / ``se3.scalar_trick`` (``"se3_transformer"``).  The
    convolutions' keys are :func:`state_dict_from_gconv_params`'s, the norm
    layers' ``bn_{d}`` / ``bn_{d}_{i}`` (``LayerNorm``) and ``lin_{d}_{i}``:
    the JAX tree's names, as for FastTFN's TFN."""
    sd: Dict[str, torch.Tensor] = {}
    _flax_modules(sd, "se3.", params["se3"])
    return sd


def state_dict_from_tfn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``TFN`` (pooled) ``state_dict`` for a JAX ``TFN`` param tree:
    ``conv_{i}``, ``norm_{i}``, ``conv_out`` as in
    :func:`state_dict_from_ourdynamics_params`, then ``fc0`` and ``fc1``."""
    sd: Dict[str, torch.Tensor] = {}
    _flax_modules(sd, "", params)
    return sd


def state_dict_from_se3transformer_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``SE3Transformer`` (pooled) ``state_dict`` for a JAX
    ``SE3Transformer`` param tree: ``res_{i}``, ``norm_{i}``, ``conv_out``
    as in :func:`state_dict_from_ourdynamics_params` (no ``scalar_trick``),
    then ``fc0`` and ``fc1``."""
    sd: Dict[str, torch.Tensor] = {}
    _flax_modules(sd, "", params)
    return sd


def _count(params: Mapping, prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix))


def _base_mlp(sd: dict, prefix: str, p: Mapping) -> None:
    """A JAX ``BaseMLP`` ``{lin0, lin1}`` -> the reference ``prefix.mlp.{0,2}``."""
    _two(sd, f"{prefix}.mlp", p, "lin0", "lin1")


def _egnn(sd: dict, prefix: str, params: Mapping) -> None:
    _linear(sd, f"{prefix}embedding", params["embedding"])
    for i in range(_count(params, "layer_")):
        p, q = params[f"layer_{i}"], f"{prefix}layers.{i}"
        _base_mlp(sd, f"{q}.edge_message_net.scalar_net", p["edge_message_net"]["scalar_net"])
        for name in ("coord_net", "node_net", "node_v_net"):
            if name in p:
                _base_mlp(sd, f"{q}.{name}", p[name])


def _scalar_nets(sd: dict, prefix: str, p: Mapping) -> None:
    """An ``EquivariantScalarNet`` or ``EquivariantEdgeScalarNet``."""
    for name in ("in_scalar_net", "out_vector_net", "out_scalar_net"):
        if name in p:
            _base_mlp(sd, f"{prefix}.{name}", p[name])


def state_dict_from_egnn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``EGNN`` ``state_dict`` for a JAX ``EGNN`` param tree (layer
    count and ``with_v`` read from the tree)."""
    sd: Dict[str, torch.Tensor] = {}
    _egnn(sd, "", params)
    return sd


def state_dict_from_gnn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``GNN`` ``state_dict`` for a JAX ``GNN`` param tree."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding", params["embedding"])
    _two(sd, "decoder", params, "dec0", "dec1")
    for i in range(_count(params, "layer_")):
        for name in ("edge_message_net", "node_net"):
            _base_mlp(sd, f"layers.{i}.{name}", params[f"layer_{i}"][name])
    return sd


def state_dict_from_rfvel_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``RFVel`` ``state_dict`` for a JAX ``RFVel`` param tree."""
    sd: Dict[str, torch.Tensor] = {}
    for g, p in _layers(params):
        _two(sd, f"{g}.phi", p, "phi0", "phi1")
        _two(sd, f"{g}.coord_mlp_vel", p, "vel0", "vel1")
    return sd


def state_dict_from_linear_dynamics_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``LinearDynamics`` ``state_dict``: the one ``time``."""
    return {"time": _t(params["time"])}


def state_dict_from_egmn_params(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port ``EGMN`` ``state_dict`` (keys after ``prefix``) for a JAX
    ``EGMN`` param tree."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(_count(params, "layer_")):
        _scalar_nets(sd, f"{prefix}layers.{i}", params[f"layer_{i}"])
    return sd


def state_dict_from_eghn_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``EGHN`` ``state_dict`` for a JAX ``EGHN`` param tree (depths
    and ``with_v`` read from the tree): ``embedding``, the two EGNNs
    ``low_force_net`` / ``high_force_net``, ``low_pooling`` (its
    ``layers.{i}`` and ``pooling.{0,2}``) and ``kinematics_net`` (an
    ``EquivariantScalarNet``, or an ``EGMN``'s ``layers.{i}``)."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding", params["embedding"])
    _egnn(sd, "low_force_net.", params["low_force_net"])
    _egnn(sd, "high_force_net.", params["high_force_net"])
    pooling = params["low_pooling"]
    _two(sd, "low_pooling.pooling", pooling, "pool0", "pool1")
    for i in range(_count(pooling, "layer_")):
        p, q = pooling[f"layer_{i}"], f"low_pooling.layers.{i}"
        _scalar_nets(sd, f"{q}.edge_message_net", p["edge_message_net"])
        _base_mlp(sd, f"{q}.node_net", p["node_net"])
    kin = params["kinematics_net"]
    if "layer_0" in kin:
        sd.update(state_dict_from_egmn_params(kin, "kinematics_net."))
    else:
        _scalar_nets(sd, "kinematics_net", kin)
    return sd


def state_dict_from_schnet_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``SchNet`` ``state_dict`` for a JAX ``SchNet`` param tree
    (the interaction count read from the tree)."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding", params["embedding"])
    for i in range(_count(params, "interaction_")):
        block, s = params[f"interaction_{i}"], f"interactions.{i}"
        _two(sd, f"{s}.conv.nn", block["conv"], "nn0", "nn1")
        _linear(sd, f"{s}.conv.lin1", block["conv"]["lin1"])
        _linear(sd, f"{s}.conv.lin2", block["conv"]["lin2"])
        _linear(sd, f"{s}.lin", block["lin"])
        _linear(sd, f"coord_updates.{i}", params[f"coord_update_{i}"])
    return sd


def state_dict_from_fullmlp_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FullMLP`` ``state_dict`` for a JAX ``FullMLP`` param tree:
    ``embedding``, ``layers.{i}.mlp.{0,2}``, ``output``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding", params["embedding"])
    for i in range(_count(params, "layer_")):
        _base_mlp(sd, f"layers.{i}", params[f"layer_{i}"])
    _linear(sd, "output", params["output"])
    return sd


def _gvp_cell(sd: dict, prefix: str, p: Mapping) -> None:
    """A JAX ``GVPCell`` ``{wh, ws, wv}``."""
    for name in ("wh", "ws", "wv"):
        _linear(sd, f"{prefix}.{name}", p[name])


def _tuple_ln(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.scalar_norm.weight"] = _t(p["scalar_norm"]["scale"])
    sd[f"{prefix}.scalar_norm.bias"] = _t(p["scalar_norm"]["bias"])


def state_dict_from_gvpnet_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``GVPNet`` ``state_dict`` for a JAX ``GVPNet`` param tree
    (depths read from the tree): ``W_v`` / ``W_e`` / ``W_out`` as ``.0``
    (tuple LayerNorm) and ``.1`` (GVP), ``layers.{i}.conv.message_func.{j}``,
    ``layers.{i}.norm.{0,1}``, ``layers.{i}.ff_func.{j}``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, key in (("W_v", "wv"), ("W_e", "we"), ("W_out", "out")):
        _tuple_ln(sd, f"{name}.0", params[f"{key}_norm"])
        _gvp_cell(sd, f"{name}.1", params[f"{key}_gvp"])
    for i in range(_count(params, "layer_")):
        p, q = params[f"layer_{i}"], f"layers.{i}"
        for j in range(_count(p["conv"], "message")):
            _gvp_cell(sd, f"{q}.conv.message_func.{j}", p["conv"][f"message{j}"])
        for j in range(2):
            _tuple_ln(sd, f"{q}.norm.{j}", p[f"norm{j}"])
        for j in range(_count(p, "ff")):
            _gvp_cell(sd, f"{q}.ff_func.{j}", p[f"ff{j}"])
    return sd


def dimenet_output_block(sd: dict, prefix: str, p: Mapping) -> None:
    """A JAX DimeNet ``OutputBlock`` / ``OutputPPBlock``: ``lin_rbf``,
    ``lin_up`` (++), ``lin_{i}`` -> ``lins.{i}``, ``lin_out`` -> ``lin``."""
    for name in ("lin_rbf", "lin_up"):
        if name in p:
            _linear(sd, f"{prefix}.{name}", p[name])
    for i in range(sum(1 for k in p if k[4:].isdigit())):
        _linear(sd, f"{prefix}.lins.{i}", p[f"lin_{i}"])
    _linear(sd, f"{prefix}.lin", p["lin_out"])


def dimenet_interaction_block(sd: dict, prefix: str, p: Mapping) -> None:
    """A JAX DimeNet ``InteractionBlock`` / ``InteractionPPBlock``: its
    linears and ``W`` under their names, ``res_{before,after}_{i}`` ->
    ``layers_{before,after}_skip.{i}``."""
    for name, sub in p.items():
        if name == "W":
            sd[f"{prefix}.W"] = _t(sub)
        elif name.startswith("res_"):
            _, stack, i = name.split("_")
            for lin in ("lin1", "lin2"):
                _linear(sd, f"{prefix}.layers_{stack}_skip.{i}.{lin}", sub[lin])
        else:
            _linear(sd, f"{prefix}.{name}", sub)


def state_dict_from_dimenet_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``DimeNet`` (or DimeNet++, told by its output blocks'
    ``lin_up``) ``state_dict`` for a JAX ``DimeNet`` param tree: ``rbf.freq``,
    ``emb.{emb,lin_rbf,lin}``, ``output_blocks.{b}`` and
    ``interaction_blocks.{b}``."""
    sd: Dict[str, torch.Tensor] = {"rbf.freq": _t(params["bessel_freq"])}
    for name, key in (("emb", "emb"), ("lin_rbf", "emb_lin_rbf"), ("lin", "emb_lin")):
        _linear(sd, f"emb.{name}", params[key])
    for b in range(_count(params, "output_")):
        dimenet_output_block(sd, f"output_blocks.{b}", params[f"output_{b}"])
    for b in range(_count(params, "interaction_")):
        dimenet_interaction_block(sd, f"interaction_blocks.{b}", params[f"interaction_{b}"])
    return sd
