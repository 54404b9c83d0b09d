"""Weights from the JAX package's FastEGNN params into the port.

:func:`state_dict_from_jax_params` is the inverse of
``fastegnn_tpu/utils/torch_import.py::params_from_reference_state_dict``:
it takes the JAX param tree as a nested dict of numpy arrays and returns the
port's ``state_dict`` in the reference PyTorch layout:

- flax kernels ``[in, out]`` become torch weights ``[out, in]``;
- ``virtual_node_feat`` goes from the JAX channel-major ``[1, C, H]`` back
  to the reference ``[1, H, C]``;
- the rows of ``node_mlp.lin0``'s kernel that read the flattened virtual
  messages go from the JAX ``[C, H]`` order back to the reference ``[H, C]``
  order (``torch_import.py:68-78``).
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


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``FastEGNN`` ``state_dict`` for a JAX ``FastEGNN`` param tree
    (layer count, widths, gravity and attention read from the tree)."""
    vnf = np.asarray(params["virtual_node_feat"])          # [1, C, H]
    C, H = vnf.shape[1], vnf.shape[2]
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding_in", params["embedding_in"])
    sd["virtual_node_feat"] = _t(np.transpose(vnf, (0, 2, 1)))
    n_layers = sum(1 for k in params if k.startswith("gcl_"))
    for i in range(n_layers):
        p, g = params[f"gcl_{i}"], f"gcl_{i}"
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
                _linear(sd, f"{g}.{name}.0", p[name][a])
                _linear(sd, f"{g}.{name}.2", p[name][b])
        K = np.asarray(p["node_mlp"]["lin0"]["kernel"])     # [in, out]
        virt = K[2 * H: 2 * H + C * H]
        virt = virt.reshape(C, H, -1).transpose(1, 0, 2).reshape(C * H, -1)
        K = np.concatenate([K[:2 * H], virt, K[2 * H + C * H:]], axis=0)
        _linear(sd, f"{g}.node_mlp.0", {"kernel": K, "bias": p["node_mlp"]["lin0"]["bias"]})
        _linear(sd, f"{g}.node_mlp.2", p["node_mlp"]["lin1"])
        if "att_mlp" in p:
            _linear(sd, f"{g}.att_mlp.0", p["att_mlp"])
            _linear(sd, f"{g}.att_mlp_virtual.0", p["att_mlp_virtual"])
    return sd
