"""What every configuration's plain reference shares: the graph rebuilt
from the raw frames, the check of the port's collated batch against it,
the MSE + MMD loss, the MMD draw, Adam, and three training steps.

Plain PyTorch in f32 with TF32 off (the control turns it on); it imports
nothing of the port.  A configuration's module (``reference/<config>.py``)
gives ``forward(params, graph, cfg) -> (coord [n, 3], virtual [C, 3])``
for one graph; the steps run it graph by graph, so that the largest
batch fits beside nothing else, and sum the graphs' shares of the loss.

The semantics are the reference project's (GLAD-RUC/FastEGNN):

- the graph: every ordered pair within ``radius`` (no self loops), then
  the shortest ``1 - cutoff_rate`` of them; edge attributes ``[d, d]``;
  node features ``[|v|, s / max s]`` (``datasets/simulation/dataset.py``,
  ``datasets/protein/dataset.py``);
- the loss: the MSE over real nodes plus ``weight * (l_vv - l_rv)`` with
  the kernel ``exp(-||x - y|| / (2 sigma^2))`` over the virtual nodes and
  ``sample * C`` real nodes drawn per graph (``utils/train.py``);
- the optimizer: Adam with coupled weight decay (``torch.optim.Adam``'s
  update, written out).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class RefGraph:
    loc: torch.Tensor          # [n, 3]
    vel: torch.Tensor          # [n, 3]
    target: torch.Tensor       # [n, 3]
    node_feat: torch.Tensor    # [n, 2]
    node_attr: torch.Tensor    # [n, 1]
    dst: torch.Tensor          # [E] int64
    src: torch.Tensor          # [E] int64
    edge_attr: torch.Tensor    # [E, 2]
    cand_key: torch.Tensor     # [P2] int64 sorted keys dst * n + src of every pair within radius
    cand_d: torch.Tensor       # [P2] f64 their lengths, in key order
    n_keep: int                # edges the cutoff keeps
    d_keep: float              # the longest kept length (f64)

    @property
    def n(self) -> int:
        return self.loc.shape[0]


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 matrix products with TF32 off, or on (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _pairs_within(loc64: torch.Tensor, radius: float, rows: int = 1024):
    """``(a, b, d)``: every pair ``a < b`` with ``|loc_a - loc_b| <= radius``
    (f64), by rows against all."""
    n = loc64.shape[0]
    ar, br, dr = [], [], []
    cols = torch.arange(n, device=loc64.device)
    for lo in range(0, n, rows):
        d2 = ((loc64[lo:lo + rows, None, :] - loc64[None, :, :]) ** 2).sum(-1)
        rid = torch.arange(lo, min(lo + rows, n), device=loc64.device)
        hit = (d2 <= radius * radius) & (cols[None, :] > rid[:, None])
        a, b = hit.nonzero(as_tuple=True)
        ar.append(a + lo)
        br.append(b)
        dr.append(d2[a, b].sqrt())
    return torch.cat(ar), torch.cat(br), torch.cat(dr)


def rebuild_graph(raw, radius: float, cutoff_rate: float, device) -> RefGraph:
    """One sample's graph from its raw frames.  The pairs within radius are
    found on the device in f64; the cutoff orders them by their f32
    lengths as the loaders compute them (numpy's norm of the f32
    difference, a stable sort; both directions of a pair tie, the one
    with the lower dst first)."""
    f32 = dict(dtype=torch.float32, device=device)
    loc = torch.as_tensor(np.asarray(raw.loc), **f32)
    vel = torch.as_tensor(np.asarray(raw.vel), **f32)
    target = torch.as_tensor(np.asarray(raw.target), **f32)
    scalar = torch.as_tensor(np.asarray(raw.scalar), **f32)
    n = loc.shape[0]
    a, b, d64 = _pairs_within(loc.double(), radius)
    dst, src = torch.cat([a, b]), torch.cat([b, a])
    d64 = torch.cat([d64, d64])
    loc_np = np.asarray(raw.loc, np.float32)
    dst_np, src_np = dst.cpu().numpy(), src.cpu().numpy()
    d32 = np.linalg.norm(loc_np[dst_np] - loc_np[src_np], axis=1)
    k = int(dst.numel() * (1.0 - cutoff_rate))
    order = torch.as_tensor(np.argsort(d32, kind="stable")[:k], device=device)
    key = dst * n + src
    ks, ko = torch.sort(key)
    edge_d = torch.as_tensor(d32, device=device)[order]
    return RefGraph(
        loc=loc, vel=vel, target=target,
        node_feat=torch.cat([vel.norm(dim=1, keepdim=True), scalar / scalar.max()], 1),
        node_attr=scalar, dst=dst[order], src=src[order],
        edge_attr=torch.stack([edge_d, edge_d], 1), cand_key=ks, cand_d=d64[ko],
        n_keep=k, d_keep=float(d64[order].max()) if k else 0.0)


# --- the port's batch against the rebuilt graphs ----------------------------

BATCH_FIELDS = ("coord", "vel", "coord_target", "node_feat", "node_mask", "dst", "src",
                "edge_attr", "rowptr", "dst_count", "loc_mean")


def host_batch(batch) -> dict:
    """The fields of a collated batch that the check reads, on the host."""
    ne = int(batch.n_real_edges)
    out = {}
    for f in BATCH_FIELDS:
        t = getattr(batch, f)
        if f in ("dst", "src", "edge_attr"):
            t = t[:ne]
        out[f] = t.detach().cpu().numpy()
    out["n_graphs"] = int(batch.n_graphs)
    out["n_real_edges"] = ne
    return out


def _mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Entries that differ by more than f32 rounding of a short sum
    (1e-6 relative to 1 + |b|), or where the shapes differ: all."""
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((np.abs(a.astype(np.float64) - b) > 1e-6 * (1.0 + np.abs(b))).sum())


def batch_mismatch(hb: dict, graphs: List[RefGraph], cutoff_rate: float) -> Dict[str, int]:
    """How many entries of the port's batch break what the raw frames say,
    by part: node rows, the edge set (every edge a pair within radius, as
    many as the cutoff keeps, none longer than the kept, no shorter pair
    left out, no duplicate), edge attributes, the CSR row pointer and
    in-degrees, and the per-graph mean positions.  All 0 for a right
    batch.  Each graph of ``graphs`` then keeps the batch's choice among
    edges of the cut's boundary length (:func:`adopt_boundary_ties`)."""
    B = hb["n_graphs"]
    N = hb["coord"].shape[0]
    m = N // B
    bad = {k: 0 for k in ("graphs", "csr", "nodes", "loc_mean", "edge_pairs", "edge_count",
                          "edge_dup", "edge_long", "edge_missing", "edge_attr")}
    bad["graphs"] = abs(len(graphs) - B)
    dst, src = hb["dst"].astype(np.int64), hb["src"].astype(np.int64)
    # the CSR the kernels walk
    counts = np.bincount(dst, minlength=N)[:N]
    bad["csr"] = (int(np.any(np.diff(dst) < 0)) + int(hb["rowptr"][0] != 0)
                  + int((hb["rowptr"][1:] != np.cumsum(counts)).sum())
                  + _mismatch(hb["dst_count"], counts.astype(np.float64))
                  + int((dst // m != src // m).sum()))
    for g, rg in enumerate(graphs):
        n = rg.n
        rows = slice(g * m, g * m + n)
        bad["nodes"] += (int((~hb["node_mask"][rows]).sum())
                         + int(hb["node_mask"][g * m + n:(g + 1) * m].sum()))
        for f, ref in (("coord", rg.loc), ("vel", rg.vel), ("coord_target", rg.target),
                       ("node_feat", rg.node_feat)):
            bad["nodes"] += _mismatch(hb[f][rows], ref.cpu().numpy().astype(np.float64))
        # within the error bound of an f32 sum of n terms, (n - 1) 2^-24 sum |x|
        mean = rg.loc.double().mean(0).cpu().numpy()
        tol = (n - 1) * 2.0**-24 * float(rg.loc.abs().double().mean()) + 1e-7
        bad["loc_mean"] += int((np.abs(hb["loc_mean"][g].astype(np.float64) - mean[:, None])
                                > tol).sum())
        sel = dst // m == g
        d_l, s_l = dst[sel] - g * m, src[sel] - g * m
        dev = rg.cand_key.device
        key = torch.as_tensor(d_l * n + s_l, device=dev)
        pos = torch.searchsorted(rg.cand_key, key).clamp_max(rg.cand_key.numel() - 1)
        found = rg.cand_key[pos] == key
        bad["edge_pairs"] += int((~found).sum())
        bad["edge_count"] += abs(int(key.numel()) - rg.n_keep)
        bad["edge_dup"] += int(key.numel() - torch.unique(key).numel())
        bad["edge_long"] += int((rg.cand_d[pos[found]] > rg.d_keep * (1 + 1e-6)).sum())
        inside = torch.zeros(rg.cand_key.numel(), dtype=torch.bool, device=dev)
        inside[pos[found]] = True
        bad["edge_missing"] += int(((rg.cand_d < rg.d_keep * (1 - 1e-6)) & ~inside).sum())
        adopt_boundary_ties(rg, d_l, s_l)
        ea = torch.as_tensor(hb["edge_attr"][sel], device=dev).double()
        d_ref = (rg.loc[torch.as_tensor(d_l, device=dev)]
                 - rg.loc[torch.as_tensor(s_l, device=dev)]).norm(dim=1).double()
        bad["edge_attr"] += int((ea - d_ref[:, None]).abs().gt(1e-6 * (1 + d_ref[:, None])).sum())
    return bad


def adopt_boundary_ties(rg: RefGraph, d_l: np.ndarray, s_l: np.ndarray) -> None:
    """Where the batch kept other edges than ``rg`` only among those of the
    cut's boundary length (equal f32 lengths, which the loaders order by
    their neighbour search's pair order), let ``rg`` keep the batch's: the
    cut leaves that choice open.  Any other difference is left for
    :func:`batch_mismatch` to count."""
    n, dev = rg.n, rg.dst.device
    loc = rg.loc.cpu().numpy()
    mine = (rg.dst * n + rg.src).cpu().numpy()
    theirs = d_l * n + s_l
    if np.array_equal(np.sort(mine), np.sort(theirs)) or mine.size != theirs.size:
        return
    t = float(rg.edge_attr[:, 0].max())
    d_theirs = np.linalg.norm(loc[d_l] - loc[s_l], axis=1)
    below = (rg.edge_attr[:, 0] < t).cpu().numpy()
    differ = np.setxor1d(mine, theirs)
    d_mine = dict(zip(mine.tolist(), rg.edge_attr[:, 0].cpu().numpy().tolist()))
    d_th = dict(zip(theirs.tolist(), d_theirs.tolist()))
    if not all((d_mine.get(k) if k in d_mine else d_th.get(k)) == t for k in differ.tolist()):
        return
    at_t = d_theirs == t
    keep = torch.as_tensor(below, device=dev)
    dst = torch.cat([rg.dst[keep], torch.as_tensor(d_l[at_t], device=dev)])
    src = torch.cat([rg.src[keep], torch.as_tensor(s_l[at_t], device=dev)])
    d = torch.cat([rg.edge_attr[keep, 0], torch.as_tensor(d_theirs[at_t], device=dev)])
    rg.dst, rg.src, rg.edge_attr = dst, src, torch.stack([d, d], 1)


# --- loss, draw, optimizer ---------------------------------------------------

def rbf(x: torch.Tensor, y: torch.Tensor, sigma: float) -> torch.Tensor:
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2.clamp_min(1e-24).sqrt() / (2.0 * sigma * sigma))


def draw(key, per_graph: bool, n_graphs: int, n_max: int, device) -> torch.Tensor:
    """The MMD draw of a step from its host key (uint32[2]): uniform scores
    ``[B, n_max]`` (per-graph sampling) or one permutation of ``n_max``
    (shared), from a generator on the device seeded ``hi << 32 | lo``."""
    hi, lo = (int(k) for k in np.asarray(key, np.uint32))
    gen = torch.Generator(device=device).manual_seed(hi << 32 | lo)
    if per_graph:
        return torch.rand((n_graphs, n_max), generator=gen, device=device)
    return torch.randperm(n_max, generator=gen, device=device)


def graph_loss(x, vx, rg: RefGraph, g: int, the_draw, cfg: dict, n_graphs: int,
               n_real_total: int):
    """Graph ``g``'s share of the batch loss: ``(total, mse, mmd)``."""
    se = ((x - rg.target) ** 2).sum()
    mse = se / (n_real_total * 3)
    C = vx.shape[0]
    n = rg.n
    if cfg["per_graph_sampling"]:
        n_max = the_draw.shape[1]
        s = min(cfg["sample"] * C, n_max)
        idx = torch.topk(-the_draw[g, :n], s).indices
        sampled = x[idx]
    else:
        n_max = the_draw.shape[0]
        s = min(cfg["sample"] * C, n_max)
        idx = the_draw[:s]
        sampled = x[idx[idx < n]]
    k_vv = rbf(vx, vx, cfg["sigma"]).sum()
    k_rv = rbf(sampled, vx, cfg["sigma"]).sum()
    mmd = k_vv / n_graphs / C / C - 2.0 * k_rv / n_graphs / s / C
    return mse + cfg["weight"] * mmd, mse, mmd


class Adam:
    """``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``
    written out: the decay is added to the gradient before the moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p, self.lr, self.wd, self.b1, self.b2, self.eps = params, lr, weight_decay, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the gradients as the moments got them
        (zero for a leaf the loss does not reach, which is not updated, as
        in ``torch.optim.Adam``)."""
        self.t += 1
        got = {}
        for k, p in self.p.items():
            if grads[k] is None:
                got[k] = torch.zeros_like(p)
                continue
            g = grads[k] + self.wd * p
            got[k] = g.clone()
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mhat = self.m[k] / (1 - self.b1 ** self.t)
            vhat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))
        return got


@dataclasses.dataclass
class Readings:
    """What both sides give for the three checked steps."""

    mse: List[float]                        # the MSE of steps 1-3
    mmd: List[float]                        # the MMD term of steps 1-3 (before its weight)
    coord: List[np.ndarray]                 # step 1's predicted positions, per graph [n, 3]
    virtual: List[np.ndarray]               # step 1's virtual positions, per graph [C, 3]
    grad1: Dict[str, torch.Tensor]          # step 1's gradient as the optimizer got it
    change3: Dict[str, torch.Tensor]        # parameters after step 3 minus the initial ones
    extent: float = 1.0                     # largest distance of a node from its graph's mean


def train_three(forward, weights: Dict[str, torch.Tensor], graphs: List[RefGraph],
                steps, cfg: dict, n_max: int, tf32: bool = False) -> Readings:
    """The reference's three steps from ``weights`` over ``steps`` = three
    ``(pool indices, key)``, graph by graph."""
    device = next(iter(weights.values())).device
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    opt = Adam(params, cfg["learning_rate"], cfg["weight_decay"])
    mses, mmds, coord, virtual, grad1 = [], [], [], [], None
    extent = 0.0
    with precision(tf32):
        for t, (indices, key) in enumerate(steps):
            B = len(indices)
            d = draw(key, cfg["per_graph_sampling"], B, n_max, device)
            n_tot = sum(graphs[i].n for i in indices)
            mse_sum, mmd_sum = 0.0, 0.0
            for p in params.values():
                p.grad = None
            for g, i in enumerate(indices):
                rg = graphs[i]
                x, vx = forward(params, rg, cfg)
                loss, mse, mmd = graph_loss(x, vx, rg, g, d, cfg, B, n_tot)
                loss.backward()
                mse_sum += float(mse.detach().double())
                mmd_sum += float(mmd.detach().double())
                if t == 0:
                    coord.append(x.detach().cpu().numpy())
                    virtual.append(vx.detach().cpu().numpy())
                    extent = max(extent, float((rg.loc - rg.loc.mean(0)).abs().max()))
            got = opt.step({k: p.grad for k, p in params.items()})
            if t == 0:
                grad1 = got
            mses.append(mse_sum)
            mmds.append(mmd_sum)
    change3 = {k: (params[k].detach() - weights[k]) for k in params}
    return Readings(mses, mmds, coord, virtual, grad1, change3, extent)


# --- the numbers compared ----------------------------------------------------

def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in leaves}


def moved_leaves(ref_grad1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    at least a thousandth of the median leaf's norm."""
    n = {k: float(v.double().norm()) for k, v in ref_grad1.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= 1e-3 * med]


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared.  The loss gap is the first step's: Adam's
    first update moves each weight by about the learning rate times its
    gradient's sign, so elements whose gradient is nought to rounding part
    the two sides by a whole step, and the later steps' losses swing from
    seed to seed (``loss_gaps`` logs all three).  The gradient and update
    gaps are the median leaf's, over the leaves the loss reaches: the
    worst leaf is a virtual node's gate head whose gradient sums terms
    that nearly cancel (the virtual nodes start at the graph's centroid),
    so it swings with rounding alone (``worst_leaves`` logs it)."""
    loss_gap = loss_gaps(prog, ref)[0]
    # step 1's predicted real and virtual positions, against the graphs' extent
    pos = max(float(np.abs(a - b).max()) for a, b in
              zip(prog.coord + prog.virtual, ref.coord + ref.virtual))
    moved = moved_leaves(ref.grad1)
    return {
        "loss_gap": loss_gap,
        "pos_gap": pos / max(ref.extent, 1e-30),
        "grad_gap": float(np.median(list(leaf_gaps(prog.grad1, ref.grad1, moved).values()))),
        "update_gap": float(np.median(list(leaf_gaps(prog.change3, ref.change3,
                                                     moved).values()))),
    }


def loss_gaps(prog: Readings, ref: Readings) -> List[float]:
    """Each step's relative gap of the MSE and of the MMD term, the worse
    of the two (apart: their weighted sum can pass through 0)."""
    return [max(abs(pm - rm) / max(abs(rm), 1e-30), abs(pd - rd) / max(abs(rd), 1e-30))
            for pm, rm, pd, rd in zip(prog.mse, ref.mse, prog.mmd, ref.mmd)]


def worst_leaves(prog: Readings, ref: Readings, top: int = 3) -> str:
    """The leaves with the largest gradient and update gaps, for the log."""
    moved = moved_leaves(ref.grad1)
    out = []
    for what, gaps in (("grad", leaf_gaps(prog.grad1, ref.grad1, moved)),
                       ("update", leaf_gaps(prog.change3, ref.change3, moved))):
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        out.append(f"{what}: " + ", ".join(f"{k} {v:.2e}" for k, v in worst))
    return "; ".join(out)


def program_outputs(x: np.ndarray, vx: np.ndarray, n_graphs: int, n_real) -> tuple:
    """The program's step-1 outputs per graph: ``x [N, 3]`` in the batch's
    node layout and ``vx [B, 3, C]``."""
    m = x.shape[0] // n_graphs
    coord = [x[g * m:g * m + n] for g, n in enumerate(n_real)]
    virtual = [vx[g].T for g in range(n_graphs)]
    return coord, virtual
