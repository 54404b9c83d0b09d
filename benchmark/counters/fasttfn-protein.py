"""Model FLOPs of one FastTFN training step (forward and backward) for a
batch's real nodes and edges, at the configuration's widths.

Matrix products only, each counted at its least (as FastEGNN's counter:
the first layers of ``phi_e`` and ``phi_ev`` split by input block): per
layer the TFN's two radial MLPs (1 -> 32 -> 32 -> nfreq, nfreq 1 and 3)
and its kernel contractions per edge, and the virtual block per node
channel; in every layer but the last, ``phi_e`` per edge and the node and
virtual feature MLPs.  The backward counts twice the forward.
"""


def forward_flops(cfg: dict, n_graphs: int, nodes: int, edges: int) -> float:
    H, C, L = cfg["hidden"], cfg["virtual_channels"], cfg["n_layers"]
    fe, mid = 2, 32
    nc, bc = nodes * C, n_graphs * C
    radial = sum(2 * mid + 2 * mid * mid + 2 * mid * nf for nf in (1, 3))
    contraction = 2 * (1 * 3 * 1 + 3 * 3 * 3) + 2 * 3     # K h per pair, and the self term
    tfn = edges * (radial + contraction)
    virtual = (nodes * 2 * H * H + bc * 2 * (H + C) * H
               + nc * (2 * H + 2 * H * H + 2 * (2 * H * H + 2 * H)))
    features = (nodes * 2 * (2 * H * H) + edges * (2 * (1 + fe) * H + 2 * H * H)
                + nodes * (2 * (2 * H + C * H) * H + 2 * H * H)
                + bc * (2 * 2 * H * H + 2 * H * H))
    return nodes * 2 * 2 * H + L * (tfn + virtual) + (L - 1) * features


def step_flops(cfg: dict, n_graphs: int, nodes: int, edges: int, _rows: int = 0) -> float:
    """Forward plus backward (twice the forward)."""
    return 3.0 * forward_flops(cfg, n_graphs, nodes, edges)
