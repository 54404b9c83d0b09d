"""Fused FastEGNN real-edge block: CUDA kernels, plain versions, autograd.

Replaces the Pallas TPU kernels ``fastegnn_tpu/ops/edge_kernel_v5.py::
_fwd_kernel`` and ``::_bwd_kernel`` and keeps the contract of their public
op ``fused_edge_block_v5``: inputs ``(h, x, W1, b1, W2, b2, Wg1, bg1, wg2)``
(weights ``[in, out]``), outputs ``m_sum [N, 64]`` and ``t_sum [N, 3]`` (f32
sums over each node's incoming real edges; the caller divides by the
in-degree), and gradients for all nine inputs.  Per real edge ``e = (d, s)``:

    z1   = [h_d, h_s, |x_d - x_s|^2, ea_e] W1 + b1
    m_e  = silu(silu(z1) W2 + b2)
    gate = silu(m_e Wg1 + bg1) wg2
    m_sum[d] += m_e,  t_sum[d] += (x_d - x_s) gate

The first linear is folded into node tables built outside the kernels with
``torch.matmul``: ``Ud = h W1[0:64] + b1`` and ``Us = h W1[64:128]``.  The
kernels (``csrc/edge_block.cu``; design and bound in its header) walk the
dst CSR ``rowptr`` / ``src`` of the whole batch in one launch each and run
the two 64x64 chain products in their bodies; in bf16 the forward and the
backward run their products on the tensor cores, from shared stage code, so
the backward recomputes the forward's chain bit for bit.  The f32 backward
runs its chain and weight-gradient products as register-tiled FP32
products over tiles of 48 edges, in a persistent grid of two blocks per SM
that each add their weight gradients once.  The backward
returns the per-node sums ``dUd`` / ``dUs`` and the epilogue turns them
into ``dh``, ``dW1`` and ``db1`` with three matmuls, as the JAX op does.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``
count kernel launches.

Compute modes: f32, and bf16 where the tables are bf16, the weights are
rounded to bf16 and the chain's pre-activations, sigmoid / silu outputs and
backward deltas are rounded to bf16 where the JAX kernel casts them; every
sum stays f32.  (The JAX bf16 path computes the sigmoid through tanh; this
port uses the logistic in both modes, within the bf16 tolerance.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

H = 64
FE_MAX = 3
# weight pack / weight-grad layout ([PACK_ROWS, 64] f32), shared with the kernels
ROW_W2, ROW_WG1, ROW_W1E, ROW_W1R, ROW_WG2, ROW_B2, ROW_BG1 = 0, 64, 128, 131, 132, 133, 134
PACK_ROWS = 136

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def _rnd(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Round to bf16 and back (identity in f32 mode)."""
    return t.to(torch.bfloat16).float() if bf16 else t


def build_tables(h, W1, b1, bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node tables ``Ud = h W1_dst + b1`` and ``Us = h W1_src``, stored in the
    compute dtype (products of rounded operands, summed in f32)."""
    hc = _rnd(h.float(), bf16)
    ud = _rnd(hc @ _rnd(W1[0:H].float(), bf16) + b1.float(), bf16)
    us = _rnd(hc @ _rnd(W1[H:2 * H].float(), bf16), bf16)
    cd = torch.bfloat16 if bf16 else torch.float32
    return ud.to(cd).contiguous(), us.to(cd).contiguous()


def pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16: bool) -> torch.Tensor:
    """The chain weights as one f32 ``[PACK_ROWS, 64]`` pack (layout above);
    the matrices are rounded to the compute dtype, the vectors stay f32."""
    fe = W1.shape[0] - 2 * H - 1
    p = W1.new_zeros((PACK_ROWS, H), dtype=torch.float32)
    p[ROW_W2:ROW_W2 + H] = _rnd(W2.float(), bf16)
    p[ROW_WG1:ROW_WG1 + H] = _rnd(Wg1.float(), bf16)
    p[ROW_W1E:ROW_W1E + fe] = _rnd(W1[2 * H + 1:].float(), bf16)
    p[ROW_W1R] = W1[2 * H].float()
    p[ROW_WG2] = wg2[:, 0].float()
    p[ROW_B2] = b2.float()
    p[ROW_BG1] = bg1.float()
    return p


def _dsilu(z, s):
    return s * (1.0 + z * (1.0 - s))


def _chain(ud, us, x, dst, src, ea, wpack, bf16):
    """The forward chain of every edge (plain version; differentiable)."""
    r = lambda t: _rnd(t, bf16)  # noqa: E731
    fe = ea.shape[1]
    w2, wg1 = wpack[ROW_W2:ROW_W2 + H], wpack[ROW_WG1:ROW_WG1 + H]
    w1e, w1r = wpack[ROW_W1E:ROW_W1E + fe], wpack[ROW_W1R]
    wg2, b2, bg1 = wpack[ROW_WG2], wpack[ROW_B2], wpack[ROW_BG1]
    ea_r = r(ea)
    diff = x[dst] - x[src]
    radial = (diff * diff).sum(1, keepdim=True)
    z1 = r(ud.float()[dst] + us.float()[src] + radial * w1r + ea_r @ w1e)
    s1 = r(torch.sigmoid(z1))
    a1 = r(z1 * s1)
    z2 = r(a1 @ w2 + b2)
    s2 = r(torch.sigmoid(z2))
    m = r(z2 * s2)
    zg = r(m @ wg1 + bg1)
    sg = r(torch.sigmoid(zg))
    g1 = r(zg * sg)
    gate = (g1 * wg2).sum(1, keepdim=True)
    return dict(ea_r=ea_r, diff=diff, radial=radial, z1=z1, s1=s1, a1=a1,
                z2=z2, s2=s2, m=m, zg=zg, sg=sg, g1=g1, gate=gate)


def _real_edges(rowptr, src, dst=None):
    n_e = int(rowptr[-1])
    s = src[:n_e].long()
    if dst is None:
        n = rowptr.shape[0] - 1
        d = torch.repeat_interleave(
            torch.arange(n, device=rowptr.device), (rowptr[1:] - rowptr[:-1]).long())
    else:
        d = dst[:n_e].long()
    return n_e, d, s


def edge_block_fwd_plain(ud, us, x, rowptr, src, ea, wpack, bf16: bool):
    """Plain PyTorch version of the forward kernel: ``(m_sum, t_sum)``."""
    n = x.shape[0]
    n_e, d, s = _real_edges(rowptr, src)
    c = _chain(ud, us, x, d, s, ea[:n_e], wpack, bf16)
    m_sum = x.new_zeros((n, H)).index_add(0, d, c["m"])
    t_sum = x.new_zeros((n, 3)).index_add(0, d, c["diff"] * c["gate"])
    return m_sum, t_sum


def edge_block_bwd_plain(ud, us, x, rowptr, src, dst, ea, wpack, dms, dts, bf16: bool):
    """Plain PyTorch version of the backward kernel, written out by hand.

    ``dms`` [N, 64] / ``dts`` [N, 3] are the upstream gradients of m_sum /
    t_sum (already rounded in bf16 mode).  Returns ``(dUd, dUs, dx, dw)``:
    the gradients of the node tables Ud and Us, of x, and the weight-grad
    pack ``[PACK_ROWS, 64]`` (layout of :func:`pack_weights`; the dW1
    radial and edge-attr rows, dW2, dWg1, dwg2, db2, dbg1).
    """
    n = x.shape[0]
    n_e, d, s = _real_edges(rowptr, src, dst)
    fe = ea.shape[1]
    c = chain_bwd(ud, us, x, d, s, ea[:n_e], wpack, dms[d], dts[d], bf16)
    dud = x.new_zeros((n, H)).index_add(0, d, c["d_z1_c"])
    dus = x.new_zeros((n, H)).index_add(0, s, c["d_z1_c"])
    dx = x.new_zeros((n, 3)).index_add(0, d, c["d_diff"]).index_add(0, s, -c["d_diff"])
    dw = x.new_zeros((PACK_ROWS, H))
    dw[ROW_W2:ROW_W2 + H] = c["a1"].T @ c["d_z2_c"]
    dw[ROW_WG1:ROW_WG1 + H] = c["m"].T @ c["d_zg_c"]
    dw[ROW_W1E:ROW_W1E + fe] = c["ea_r"].T @ c["d_z1_c"]
    dw[ROW_W1R] = (_rnd(c["radial"], bf16) * c["d_z1_c"]).sum(0)
    dw[ROW_WG2] = (c["g1"] * c["d_gate"]).sum(0)
    dw[ROW_B2] = c["d_z2"].sum(0)
    dw[ROW_BG1] = c["d_zg"].sum(0)
    return dud, dus, dx, dw


def chain_bwd(ud, us, x, dst, src, ea, wpack, dm, dt, bf16: bool):
    """The forward chain of every edge and its backward from the per-edge
    upstream gradients ``dm`` [E, 64] / ``dt`` [E, 3]: the dict of
    :func:`_chain` plus ``d_gate``, ``d_diff``, the deltas ``d_zg``,
    ``d_z2``, ``d_z1`` and their rounded copies ``*_c``.  In bf16 mode the
    operands of the six 64x64 products (``a1``, ``m``, ``d_zg_c``,
    ``d_z2_c`` and the W2 / Wg1 pack rows) and of the dUd / dW1 sums
    (``d_z1_c``, ``ea_r`` and the rounded radial) are bf16 values, which the
    tensor-core kernels rely on."""
    r = lambda t: _rnd(t, bf16)  # noqa: E731
    c = _chain(ud, us, x, dst, src, ea, wpack, bf16)
    w2, wg1 = wpack[ROW_W2:ROW_W2 + H], wpack[ROW_WG1:ROW_WG1 + H]
    wg2, w1r = wpack[ROW_WG2], wpack[ROW_W1R]
    d_gate = (c["diff"] * dt).sum(1, keepdim=True)
    d_zg = d_gate * wg2 * _dsilu(c["zg"], c["sg"])
    d_zg_c = r(d_zg)
    d_z2 = (dm + d_zg_c @ wg1.T) * _dsilu(c["z2"], c["s2"])
    d_z2_c = r(d_z2)
    d_z1 = (d_z2_c @ w2.T) * _dsilu(c["z1"], c["s1"])
    d_z1_c = r(d_z1)
    d_radial = (d_z1 * w1r).sum(1, keepdim=True)
    d_diff = dt * c["gate"] + 2.0 * c["diff"] * d_radial
    return dict(c, d_gate=d_gate, d_diff=d_diff, d_zg=d_zg, d_zg_c=d_zg_c, d_z2=d_z2,
                d_z2_c=d_z2_c, d_z1=d_z1, d_z1_c=d_z1_c)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    from fastegnn_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("edge_block")
    if lib.fastegnn_edge_fwd.argtypes is None:
        lib.fastegnn_edge_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P]
        lib.fastegnn_edge_fwd.restype = _I
        lib.fastegnn_edge_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                                          _P, _P, _P, _P, _P, _I, _P]
        lib.fastegnn_edge_bwd.restype = _I
    return lib


def _check_cuda(bf16: bool, ud, us, x, rowptr, src, ea, wpack, **more):
    n = x.shape[0]
    dev = x.device
    table = torch.bfloat16 if bf16 else torch.float32
    want = dict(ud=(ud, (n, H), table), us=(us, (n, H), table),
                x=(x, (n, 3), torch.float32), rowptr=(rowptr, (n + 1,), torch.int32),
                wpack=(wpack, (PACK_ROWS, H), torch.float32))
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if src.dtype != torch.int32 or src.dim() != 1:
        raise ValueError("src must be a 1-D int32 tensor")
    if ea.dtype != torch.float32 or ea.dim() != 2 or ea.shape[0] != src.shape[0] \
            or ea.shape[1] > FE_MAX:
        raise ValueError(f"edge_attr must be f32 [E, <= {FE_MAX}] matching src")
    for name, t in dict(ud=ud, us=us, x=x, rowptr=rowptr, src=src, ea=ea,
                        wpack=wpack, **more).items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA edge-block kernel launch failed: cudaError {err}")


def edge_block_fwd(ud, us, x, rowptr, src, ea, wpack, bf16: bool):
    """Forward of the fused edge block: ``(m_sum [N, 64], t_sum [N, 3])`` f32.

    CPU tensors run :func:`edge_block_fwd_plain`; CUDA tensors launch the
    kernel (``csrc/edge_block.cu``) or raise."""
    global FWD_LAUNCHES
    if x.device.type == "cpu":
        return edge_block_fwd_plain(ud, us, x, rowptr, src, ea, wpack, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(bf16, ud, us, x, rowptr, src, ea, wpack)
    lib = _lib()
    n = x.shape[0]
    m_sum = torch.empty((n, H), dtype=torch.float32, device=x.device)
    t_sum = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _call(lib.fastegnn_edge_fwd, int(bf16), ud.data_ptr(), us.data_ptr(), x.data_ptr(),
          rowptr.data_ptr(), src.data_ptr(), ea.data_ptr(), ea.shape[1],
          wpack.data_ptr(), m_sum.data_ptr(), t_sum.data_ptr(), n, stream)
    FWD_LAUNCHES += 1
    return m_sum, t_sum


def edge_block_bwd(ud, us, x, rowptr, src, dst, ea, wpack, dms, dts, bf16: bool):
    """Backward of the fused edge block: ``(dUd, dUs, dx, dw)`` as
    :func:`edge_block_bwd_plain` returns them.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  The kernel sums the src-role terms (dUs, the src part of dx) and
    the weight grads with f32 atomics, so those vary in the last bits from
    run to run; dUd is deterministic."""
    global BWD_LAUNCHES
    if x.device.type == "cpu":
        return edge_block_bwd_plain(ud, us, x, rowptr, src, dst, ea, wpack, dms, dts, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[0]
    _check_cuda(bf16, ud, us, x, rowptr, src, ea, wpack, dst=dst, dms=dms, dts=dts)
    if dst.dtype != torch.int32 or dst.shape != src.shape:
        raise ValueError("dst must be int32 shaped like src")
    if dms.shape != (n, H) or dts.shape != (n, 3) or dms.dtype != torch.float32 \
            or dts.dtype != torch.float32:
        raise ValueError("dms / dts must be f32 [N, 64] / [N, 3]")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dud = torch.zeros((n, H), **f32)
    dus = torch.zeros((n, H), **f32)
    dxd = torch.zeros((n, 3), **f32)
    dxs = torch.zeros((n, 3), **f32)
    dw = torch.zeros((PACK_ROWS, H), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _call(lib.fastegnn_edge_bwd, int(bf16), ud.data_ptr(), us.data_ptr(), x.data_ptr(),
          rowptr.data_ptr(), src.data_ptr(), dst.data_ptr(), ea.data_ptr(), ea.shape[1],
          wpack.data_ptr(), dms.data_ptr(), dts.data_ptr(), dud.data_ptr(),
          dus.data_ptr(), dxd.data_ptr(), dxs.data_ptr(), dw.data_ptr(), n, stream)
    BWD_LAUNCHES += 1
    return dud, dus, dxd - dxs, dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class EdgeBlock(torch.autograd.Function):
    """``(m_sum, t_sum)`` of the fused edge block, differentiable in
    ``(h, x, W1, b1, W2, b2, Wg1, bg1, wg2)``."""

    @staticmethod
    def forward(ctx, h, x, W1, b1, W2, b2, Wg1, bg1, wg2, rowptr, src, dst, ea, bf16):
        ud, us = build_tables(h, W1, b1, bf16)
        wpack = pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
        m_sum, t_sum = edge_block_fwd(ud, us, x, rowptr, src, ea, wpack, bf16)
        ctx.save_for_backward(h, x, W1, ud, us, wpack, rowptr, src, dst, ea)
        ctx.bf16 = bf16
        return m_sum, t_sum

    @staticmethod
    def backward(ctx, d_msum, d_tsum):
        h, x, W1, ud, us, wpack, rowptr, src, dst, ea = ctx.saved_tensors
        bf = ctx.bf16
        n = x.shape[0]
        dms = (_rnd(d_msum.float(), bf) if d_msum is not None
               else x.new_zeros((n, H))).contiguous()
        dts = (_rnd(d_tsum.float(), bf) if d_tsum is not None
               else x.new_zeros((n, 3))).contiguous()
        dud, dus, dx, dw = edge_block_bwd(ud, us, x, rowptr, src, dst, ea, wpack,
                                          dms, dts, bf)
        # epilogue: per-node table grads -> dh, dW1 (dst / src blocks), db1
        fe = W1.shape[0] - 2 * H - 1
        dud_c, dus_c = _rnd(dud, bf), _rnd(dus, bf)
        hc = _rnd(h.float(), bf)
        dh = dud_c @ _rnd(W1[0:H].float(), bf).T + dus_c @ _rnd(W1[H:2 * H].float(), bf).T
        dW1 = torch.cat([hc.T @ dud_c, hc.T @ dus_c, dw[ROW_W1R:ROW_W1R + 1],
                         dw[ROW_W1E:ROW_W1E + fe]], dim=0)
        return (dh.to(h.dtype), dx, dW1.to(W1.dtype), dud.sum(0),
                dw[ROW_W2:ROW_W2 + H], dw[ROW_B2], dw[ROW_WG1:ROW_WG1 + H], dw[ROW_BG1],
                dw[ROW_WG2][:, None], None, None, None, None, None)


def fused_edge_block(h, x, rowptr, src, dst, edge_attr, W1, b1, W2, b2, Wg1, bg1, wg2,
                     compute_dtype=torch.float32):
    """``(m_sum [N, 64], t_sum [N, 3])``: f32 sums over incoming real edges
    of the FastEGNN edge block (contract of ``fused_edge_block_v5``).

    ``rowptr`` [N + 1] / ``src`` / ``dst`` [E] int32 describe the dst-sorted
    edges (only ``rowptr[N]`` real edges are read); ``edge_attr`` [E, Fe]
    with Fe <= 3; weights ``[in, out]``.
    """
    if h.shape[1] != H:
        raise ValueError(f"the fused edge block needs hidden == {H}, got {h.shape[1]}")
    if edge_attr.shape[1] > FE_MAX:
        raise ValueError(f"the fused edge block takes at most {FE_MAX} edge attributes")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    return EdgeBlock.apply(h, x.float().contiguous(), W1, b1, W2, b2, Wg1, bg1, wg2,
                           rowptr, src, dst, edge_attr.float().contiguous(),
                           compute_dtype == torch.bfloat16)
