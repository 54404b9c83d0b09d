"""Model FLOPs of one FastEGNN training step (forward and backward) for a
batch's real nodes and edges, at the configuration's widths.

Matrix products only, each counted at its least: the edge MLP's first
layer split by input block (the ``h`` blocks once per node, the radial
and edge-attribute columns per edge), the virtual MLP's likewise (``h``
per node, ``vh`` and the Gram block per graph channel, the distance per
node channel).  The backward counts twice the forward (the input's and
the weight's gradients); nothing is counted as recomputed.
"""


def forward_flops(cfg: dict, n_graphs: int, nodes: int, edges: int) -> float:
    H, C, L = cfg["hidden"], cfg["virtual_channels"], cfg["n_layers"]
    fe = cfg["edge_kernels"]["fe"] if cfg.get("edge_kernels") else 2
    nc, bc = nodes * C, n_graphs * C
    per_layer = (
        # real edges: phi_e's first layer (h_dst, h_src per node; radial and
        # attributes per edge), its second layer, the gate phi_x
        nodes * 2 * (2 * H * H) + edges * (2 * (1 + fe) * H + 2 * H * H + 2 * H * H + 2 * H)
        # real <-> virtual: phi_ev's first layer (h per node, vh and Gram per
        # graph channel, the distance per node channel), its second layer,
        # the gates phi_xv and phi_X
        + nodes * 2 * H * H + bc * 2 * (H + C) * H
        + nc * (2 * H + 2 * H * H + 2 * (2 * H * H + 2 * H))
        # the velocity and gravity heads, phi_h, phi_hv
        + nodes * (2 if cfg.get("gravity") is not None else 1) * (2 * H * H + 2 * H)
        + nodes * (2 * (2 * H + C * H) * H + 2 * H * H)
        + bc * (2 * 2 * H * H + 2 * H * H))
    return nodes * 2 * 2 * H + L * per_layer


def step_flops(cfg: dict, n_graphs: int, nodes: int, edges: int, _rows: int = 0) -> float:
    """Forward plus backward (twice the forward)."""
    return 3.0 * forward_flops(cfg, n_graphs, nodes, edges)
