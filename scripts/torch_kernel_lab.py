"""Design comparisons of the port's segment-sum and edge-block kernels, on one GPU.

    python3 scripts/torch_kernel_lab.py [segment_sum] [edge_bwd] [edge_fwd]

Each variant is the committed source in ``fastegnn_tpu_torch/csrc/`` with
named constants changed, or with one part of a kernel removed, by text
substitutions that must match.
The variants compile in parallel with nvcc into ``_build/lab/`` and are timed
at the shapes ``chip_smoke.py`` uses (the 8000-node Water-3D-shaped graph,
seed 0), as medians over runs of back-to-back launches between CUDA events
(``chip_smoke.median_ms``):

- segment_sum: warps per output row and lane groups per warp, in the three
  forms of the variant path, beside ``torch.segment_reduce``;
- edge_block_fwd and edge_block_bwd in bf16: dst rows per block, blocks
  per SM (forward), an approximate sigmoid, and knockouts that each remove
  one part of the kernel to attribute its time (a knockout's output is
  wrong; only its time is read);
- edge_block_bwd in f32 (register-tiled products on the CUDA cores): edges
  per tile, rows per range, the persistent grid, the register-tile shape,
  an approximate sigmoid, and knockouts of the sigmoids, the chain
  products, the dW products, the dUd row sums, the src-role atomics, the
  warp reductions and the dw flush;
- edge_block_fwd in f32 (the same tile stages): edges per tile, the
  register-tile shape, blocks per SM, rows per range, stage 1's edge rows
  at a time, silu(zg) in the product's epilogue or in the gate pass, an
  approximate sigmoid, and knockouts of the chain
  products, the sigmoids, the Us / Ud gathers, the gate reduction, the
  t_sum additions and the m_sum row sums.

Prints one line per variant: ms, and the largest error against the plain
version relative to the largest value of each output; for the edge kernels
also ptxas's registers and spills of the kernel timed.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import median_ms  # noqa: E402
from fastegnn_tpu_torch.data.synthetic_water import build_batch  # noqa: E402
from fastegnn_tpu_torch.ops import _cuda_build, edge_kernel as ek, spmm  # noqa: E402

LAB_DIR = _cuda_build.BUILD_DIR / "lab"
TC_MARK = "// bf16 forward and backward on the tensor cores"
# the f32 tile stages that both f32 kernels use, then each kernel's section
F32_MARK = "// f32 tile stages: register-tiled FP32 products over tiles of edges"
FWD32_MARK = "// f32 forward: m_sum and t_sum over ranges of dst rows"
Edit = Callable[[str], str]


def sub(old: str, new: str, after: str = "", before: str = "") -> Edit:
    """Replace ``old`` (which must occur after ``after`` and, if given,
    before ``before``) by ``new`` there."""
    def edit(src: str) -> str:
        head, rest = src.split(after, 1) if after else ("", src)
        mid, tail = rest.split(before, 1) if before else (rest, "")
        if old not in mid:
            raise ValueError(f"variant does not match the source: {old[:60]!r}")
        return head + after + mid.replace(old, new) + (before + tail if before else "")
    return edit


def knobs(**values: int) -> Edit:
    """Set ``constexpr int NAME = value;`` for each name."""
    def edit(src: str) -> str:
        for name, value in values.items():
            src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise ValueError(f"no constant {name}")
        return src
    return edit


SEGSUM: Dict[str, List[Edit]] = {
    "committed: 4 warps x 4 groups per row": [],
    "1 warp x 1 group (one edge row in flight)": [knobs(ROW_WARPS=1, GROUPS=1)],
    "1 warp x 4 groups": [knobs(ROW_WARPS=1)],
    "2 warps x 4 groups": [knobs(ROW_WARPS=2)],
    "4 warps x 2 groups": [knobs(GROUPS=2)],
    "8 warps x 4 groups": [knobs(ROW_WARPS=8)],
}

_TILE_PRODUCT = "  const int fi = warp >> 1, fk = 2 * (warp & 1);\n  FragC c[2];"
_EXACT_SIG = "make_float2(sigmoid(z.x), sigmoid(z.y))"   # the tensor-core kernels' sigmoid2
_FAST_SIG = ("make_float2(__fdividef(1.f, 1.f + __expf(-z.x)), "
             "__fdividef(1.f, 1.f + __expf(-z.y)))")
EDGE_BWD: Dict[str, List[Edit]] = {
    "committed: 4 dst rows per block": [],
    "8 dst rows per block": [knobs(TC_ROWS=8)],
    "2 dst rows per block": [knobs(TC_ROWS=2)],
    "approximate sigmoid (__expf, __fdividef)": [sub(_EXACT_SIG, _FAST_SIG)],
    "knockout: sigmoids": [
        sub(_EXACT_SIG, "make_float2(0.5f + 0.25f * z.x, 0.5f + 0.25f * z.y)")],
    "knockout: the four chain products": [
        sub(_TILE_PRODUCT, "  if (warp >= 0) return;\n" + _TILE_PRODUCT)],
    "knockout: dW and PQ products": [
        sub("    grad_product(w.sA1, sDZ2, gW2, warp);\n    grad_product(w.sM, sDZG, gWg1, warp);\n",
            "", TC_MARK),
        sub("    rows_product<TC_TE / 16>(w.sPQ, sZ1, gPQ, warp >> 2, warp & 3, 0);\n", "",
            TC_MARK)],
    "knockout: src-role atomics": [
        sub("atomicAdd(reinterpret_cast<float2*>(dus + (long)s * H + k0), dz1c);", "", TC_MARK),
        sub("atomicAdd(dxs + 3 * s + lane, dd);", "", TC_MARK)],
    "knockout: warp reductions": [
        sub("warp_sum(g1.x * wg2.x + g1.y * wg2.y)", "(g1.x * wg2.x + g1.y * wg2.y)", TC_MARK),
        sub("warp_sum(dz1.x * w1r.x + dz1.y * w1r.y)", "(dz1.x * w1r.x + dz1.y * w1r.y)",
            TC_MARK)],
}


def f32_sub(old: str, new: str) -> Edit:
    """``sub`` within the f32 tile stages and the f32 backward (an f32
    forward variant's edit of the stages also changes the backward built
    with it, which the forward's lab does not time)."""
    return sub(old, new, F32_MARK, FWD32_MARK)


_F32_SIG = "{ return sigmoid(z); }"
EDGE_BWD_F32: Dict[str, List[Edit]] = {
    "committed: tiles of 48 edges, ranges of 8 rows, 6x2 register tiles, "
    "2 blocks per SM taking ranges from a counter": [],
    "one block per range (no persistent grid)": [knobs(BWD_PERSIST=0)],
    "3x4 register tiles": [knobs(BWD_FG=16)],
    "tiles of 32 edges (2x4 register tiles)": [knobs(TE=32, BWD_FG=16)],
    "tiles of 32 edges, ranges of 16 rows, 2x4 register tiles (the first design)": [
        knobs(TE=32, BWD_ROWS=16, BWD_FG=16)],
    "ranges of 16 rows": [knobs(BWD_ROWS=16)],
    "6 warps, 4x4 register tiles, ranges of 12 rows, dW tiles 4x8": [
        knobs(BWD_WARPS=6, BWD_PWARPS=6, BWD_FG=16, BWD_ROWS=12, BWD_DWC=8)],
    "tiles of 64 edges (4x4 register tiles), 1 block per SM": [
        knobs(TE=64, BWD_FG=16, BWD_BLOCKS=1)],
    "16 warps, tiles of 128 edges (4x4 register tiles), 1 block per SM": [
        knobs(BWD_WARPS=16, BWD_PWARPS=16, BWD_FG=16, TE=128, BWD_ROWS=16, BWD_BLOCKS=1)],
    "tiles of 128 edges (4x8 register tiles), 1 block per SM": [
        knobs(BWD_FG=8, TE=128, BWD_BLOCKS=1)],
    "tiles of 32, register tiles of 1 edge x 8 features": [knobs(TE=32, BWD_FG=8)],
    "dW tiles 4x8 (half the threads)": [knobs(BWD_DWC=8)],
    "4 of the 8 warps run the chain products (6x4 register tiles)": [
        knobs(BWD_PWARPS=4, BWD_FG=16)],
    "elementwise passes two edge rows at a time": [knobs(PG=2)],
    "elementwise passes three edge rows at a time": [knobs(PG=3)],
    "dW loop not unrolled": [f32_sub("#pragma unroll 4\n        for (int te = 0; te < TE; ++te) {",
                                     "#pragma unroll 1\n        for (int te = 0; te < TE; ++te) {")],
    "dW loop unrolled by 2": [f32_sub("#pragma unroll 4\n        for (int te = 0; te < TE; ++te) {",
                                      "#pragma unroll 2\n        for (int te = 0; te < TE; ++te) {")],
    "product k loop not unrolled": [f32_sub("#pragma unroll 2\n  for (int k = 0; k < H; k += 4) {",
                                            "#pragma unroll 1\n  for (int k = 0; k < H; k += 4) {")],
    "approximate sigmoid (__expf, __fdividef)": [
        f32_sub(_F32_SIG, "{ return __fdividef(1.f, 1.f + __expf(-z)); }")],
    "knockout: sigmoids": [f32_sub(_F32_SIG, "{ return 0.5f + 0.25f * z; }")],
    "knockout: the four chain products": [
        f32_sub("for (int k = 0; k < H; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "knockout: dW products": [
        f32_sub("for (int te = 0; te < TE; ++te) {  // weight-gradient products",
                "for (int te = 0; te < 0; ++te) {")],
    "knockout: the Us and Ud row gathers": [
        f32_sub("load2(us, (long)s * H + k0)", "make_float2(0.f, 0.f)"),
        f32_sub("load2(ud, (long)d * H + k0)", "make_float2(0.f, 0.f)")],
    "knockout: the gate and d_radial passes": [
        f32_sub("      {\n        const float2 bg1 = load2(sLW, LW_BG1 * H + k0);",
                "      if (fe < 0) {\n        const float2 bg1 = load2(sLW, LW_BG1 * H + k0);"),
        f32_sub("      {\n        const float2 w1r = load2(sLW, LW_W1R * H + k0);\n        float2 gb2",
                "      if (fe < 0) {\n        const float2 w1r = load2(sLW, LW_W1R * H + k0);\n"
                "        float2 gb2")],
    "knockout: dUd row sums": [
        f32_sub("for (int te = lo; te < hi; ++te) {", "for (int te = lo; te < lo; ++te) {")],
    "knockout: src-role atomics": [
        f32_sub("atomicAdd(reinterpret_cast<float2*>(dus + (long)s * H + k0), dz1[i]);", ""),
        f32_sub("atomicAdd(dxs + 3 * s + lane, dd);", "")],
    "knockout: the per-feature weight-gradient sums": [
        f32_sub("  atomicAdd(row + lane, v.x);\n  atomicAdd(row + 32 + lane, v.y);\n", "")],
    "knockout: the dw flush": [
        f32_sub("  {  // ---- this block's weight grads into dw, once ----", "  if (fe < 0) {")],
}


def fwd32_sub(old: str, new: str) -> Edit:
    """``sub`` within the f32 forward's section."""
    return sub(old, new, FWD32_MARK, TC_MARK)


# silu(zg) wg2 taken in the m Wg1 product's epilogue, so that the gate pass
# only sums it
_GATE_EPI = [
    fwd32_sub("      sA1[e * LDT + k] = t;\n",
              "      const float zg = t + sLW[LW_BG1 * H + k];\n"
              "      sA1[e * LDT + k] = zg * sig_f32(zg) * sLW[LW_WG2 * H + k];\n"),
    fwd32_sub("""        const float2 bg1 = load2(sLW, LW_BG1 * H + k0);
        const float2 wg2 = load2(sLW, LW_WG2 * H + k0);
        const float2 zg = make_float2(t.x + bg1.x, t.y + bg1.y);
        p[i] = zg.x * sig_f32(zg.x) * wg2.x + zg.y * sig_f32(zg.y) * wg2.y;
""", "        p[i] = t.x + t.y;\n")]


def fwd32_smem(kib: int) -> Edit:
    """Give each f32 forward block ``kib`` KiB of shared memory, so that
    fewer blocks fit on an SM than its registers would allow."""
    return sub("constexpr size_t FWD32_SMEM =\n    (",
               f"constexpr size_t FWD32_SMEM = {kib} * 1024 + 0 * (")


EDGE_FWD_F32: Dict[str, List[Edit]] = {
    "committed: one block per range of 8 rows, tiles of 64 edges, 4x4 register tiles, "
    "3 blocks per SM, silu(zg) in the gate pass": [],
    "2 blocks per SM (100 KiB of shared memory per block)": [
        knobs(FWD32_BLOCKS=2), fwd32_smem(100)],
    "1 block per SM (150 KiB of shared memory per block)": [
        knobs(FWD32_BLOCKS=1), fwd32_smem(150)],
    "tiles of 96 edges (6x4 register tiles), 2 blocks per SM, silu(zg) wg2 in the "
    "product's epilogue (the first design)": [
        knobs(FWD32_TE=96, FWD32_BLOCKS=2), *_GATE_EPI],
    "tiles of 96 edges (6x4 register tiles), 2 blocks per SM": [
        knobs(FWD32_TE=96, FWD32_BLOCKS=2)],
    "tiles of 48 edges (3x4 register tiles)": [knobs(FWD32_TE=48)],
    "2x8 register tiles": [knobs(FWD32_FG=8)],
    "tiles of 96 edges (3x8 register tiles), 2 blocks per SM": [
        knobs(FWD32_TE=96, FWD32_FG=8, FWD32_BLOCKS=2)],
    "tiles of 128 edges (8x4 register tiles), 2 blocks per SM": [
        knobs(FWD32_TE=128, FWD32_BLOCKS=2)],
    "tiles of 128 edges (4x8 register tiles), 2 blocks per SM": [
        knobs(FWD32_TE=128, FWD32_FG=8, FWD32_BLOCKS=2)],
    "ranges of 16 rows": [knobs(FWD32_ROWS=16)],
    "stage 1 two edge rows at a time": [knobs(FWD32_PG=2)],
    "stage 1 four edge rows at a time": [knobs(FWD32_PG=4)],
    "silu(zg) wg2 in the product's epilogue, not in the gate pass": _GATE_EPI,
    "product k loop not unrolled": [
        f32_sub("#pragma unroll 2\n  for (int k = 0; k < H; k += 4) {",
                      "#pragma unroll 1\n  for (int k = 0; k < H; k += 4) {")],
    "approximate sigmoid (__expf, __fdividef)": [
        f32_sub(_F32_SIG, "{ return __fdividef(1.f, 1.f + __expf(-z)); }")],
    "knockout: sigmoids": [f32_sub(_F32_SIG, "{ return 0.5f + 0.25f * z; }")],
    "knockout: the two chain products": [
        f32_sub("for (int k = 0; k < H; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "knockout: the Us and Ud row gathers": [
        f32_sub("load2(us, (long)s * H + k0)", "make_float2(0.f, 0.f)"),
        f32_sub("load2(ud, (long)d * H + k0)", "make_float2(0.f, 0.f)")],
    "knockout: the gate reduction": [
        fwd32_sub("for (int o = 16; o > 0; o >>= 1)", "for (int o = 0; o > 0; o >>= 1)")],
    "knockout: the t_sum additions": [fwd32_sub("if (r >= 0) sTS[", "if (r >= n) sTS[")],
    "knockout: the m_sum row sums": [
        fwd32_sub("for (int te = lo; te < hi; ++te) {", "for (int te = lo; te < lo; ++te) {")],
}

EDGE_FWD: Dict[str, List[Edit]] = {
    "committed: 4 dst rows per block, 3 blocks per SM": [],
    "2 blocks per SM (launch bound 2, 100 KB of shared memory per block)": [
        knobs(FWD_BLOCKS=2),
        sub("(int)FWD_SMEM);", "100 * 1024);"),
        sub("THREADS, FWD_SMEM, st>>>", "THREADS, 100 * 1024, st>>>")],
    "2 dst rows per block": [knobs(TC_ROWS=2)],
    "8 dst rows per block": [knobs(TC_ROWS=8)],
    "approximate sigmoid (__expf, __fdividef)": [sub(_EXACT_SIG, _FAST_SIG)],
    "knockout: sigmoids": [
        sub(_EXACT_SIG, "make_float2(0.5f + 0.25f * z.x, 0.5f + 0.25f * z.y)")],
    "knockout: the two chain products": [
        sub(_TILE_PRODUCT, "  if (warp >= 0) return;\n" + _TILE_PRODUCT)],
    "knockout: the one-hot m_sum product": [
        sub("    rows_product<TC_TE / 32>(w.sPQ, w.sM, gM, 0, warp & 3, "
            "(TC_TE / 32) * (warp >> 2));\n", "", TC_MARK)],
    "knockout: the gate reduction": [
        sub("warp_sum(g1.x * wg2.x + g1.y * wg2.y)", "(g1.x * wg2.x + g1.y * wg2.y)", TC_MARK)],
    "knockout: the Us gather (cp.async)": [
        sub("      cp_async16(d, g);\n      cp_async16(d + 8, g + 8);\n", "", TC_MARK)],
}


def build(source: str, variants: Dict[str, List[Edit]],
          tag: str = "") -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile every variant of ``csrc/<source>.cu`` in parallel (files named
    ``<source>_<tag><i>``) and load it: ``{name: (library, ptxas report)}``."""
    LAB_DIR.mkdir(parents=True, exist_ok=True)
    base = (_cuda_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = base
        for edit in edits:
            text = edit(text)
        cu = LAB_DIR / f"{source}_{tag}{i}.cu"
        cu.write_text(text)
        cmd = [_cuda_build.nvcc_path(), *_cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu)
    libs = {}
    for name, (proc, cu) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} variant {name!r}:\n{out}")
        libs[name] = (ctypes.CDLL(str(cu.with_suffix(".so"))), out)
    return libs


def resources(report: str, kernel: str) -> str:
    """ptxas's registers and spills of ``kernel``, from a build report."""
    return "; ".join(line.split(": ", 1)[1]
                     for line in _cuda_build.resource_lines(report)
                     if line.startswith(kernel + ":"))


def rel_err(got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def segment_sum_lab(g) -> None:
    libs = {k: lib for k, (lib, _) in build("segment_sum", SEGSUM).items()}
    n, e, f = g.num_nodes, g.n_real_edges, ek.H + 3
    data = torch.randn(e, f, generator=torch.Generator().manual_seed(1)).to(g.device)
    offsets = g.rowptr.long()
    out = torch.empty(n, f, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    for form, d, rowptr, perm in (("dst f32", data, g.rowptr, None),
                                  ("dst bf16", data.bfloat16(), g.rowptr, None),
                                  ("src f32", data, g.src_rowptr, g.src_perm)):
        want = spmm.segment_sum_csr_plain(d, rowptr, perm)
        args = (int(d.dtype == torch.bfloat16), d.data_ptr(), rowptr.data_ptr(),
                None if perm is None else perm.data_ptr(), out.data_ptr(), n, f, stream)
        if perm is None:
            ms = median_ms(lambda: torch.segment_reduce(d, "sum", offsets=offsets))
            print(f"[lab] segment_sum {form}: torch.segment_reduce {ms:.4f} ms", flush=True)
        for name, lib in libs.items():
            fn = lib.fastegnn_segment_sum
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
                [ctypes.c_void_p]
            if fn(*args) != 0:
                raise RuntimeError(f"segment_sum variant {name!r} failed to launch")
            torch.cuda.synchronize()
            err = rel_err([out], [want])
            ms = median_ms(lambda: fn(*args))
            print(f"[lab] segment_sum {form}: {name}: {ms:.4f} ms (err {err:.1e})", flush=True)


def edge_inputs(g):
    """The edge block's random inputs as ``chip_smoke.kernel_phase`` draws
    them (seed 0): ``(gen, h, (W1, b1, W2, b2, Wg1, bg1, wg2))``, ``gen``
    left for further draws."""
    gen = torch.Generator().manual_seed(0)
    dev, H, fe = g.device, ek.H, g.edge_attr.shape[1]
    W1 = (torch.randn(2 * H + 1 + fe, H, generator=gen) / (2 * H) ** 0.5).to(dev)
    W2, Wg1 = ((torch.randn(H, H, generator=gen) / H ** 0.5).to(dev) for _ in range(2))
    b1, b2, bg1 = ((torch.randn(H, generator=gen) * 0.1).to(dev) for _ in range(3))
    wg2 = (torch.randn(H, 1, generator=gen) * 0.1).to(dev)
    h = torch.randn(g.num_nodes, H, generator=gen).to(dev)
    return gen, h, (W1, b1, W2, b2, Wg1, bg1, wg2)


def edge_bwd_lab(g, f32_variants: Dict[str, List[Edit]] = EDGE_BWD_F32) -> None:
    """The backward's variants, f32 (``edge_bwd_kernel``) and bf16
    (``edge_bwd_tc_kernel``), on the graph ``g``, built in one parallel pass."""
    built = build("edge_block", {**{f"f32: {k}": v for k, v in f32_variants.items()},
                                 **{f"bf16: {k}": v for k, v in EDGE_BWD.items()}}, "bwd")
    gen, h, (W1, b1, W2, b2, Wg1, bg1, wg2) = edge_inputs(g)
    dev, H = g.device, ek.H
    n, fe = g.num_nodes, g.edge_attr.shape[1]
    dms0 = torch.randn(n, H, generator=gen).to(dev)
    dts0 = torch.randn(n, 3, generator=gen).to(dev)
    outs = [torch.zeros(shape, device=dev) for shape in
            ((n, H), (n, H), (n, 3), (n, 3), (ek.PACK_ROWS, H))]
    stream = torch.cuda.current_stream().cuda_stream
    for bf16 in (False, True):
        mode, kernel = ("bf16", "edge_bwd_tc_kernel") if bf16 else ("f32", "edge_bwd_kernel")
        dms = ek._rnd(dms0, bf16).contiguous()
        dts = ek._rnd(dts0, bf16).contiguous()
        ud, us = ek.build_tables(h, W1, b1, bf16)
        wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
        want = ek.edge_block_bwd_plain(ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr,
                                       wpack, dms, dts, bf16)
        ptrs = (ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr)
        for label, (lib, report) in built.items():
            if not label.startswith(mode + ": "):
                continue
            fn = lib.fastegnn_edge_bwd
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] + \
                [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]

            def call():
                for o in outs:   # the wrapper zeroes its outputs too
                    o.zero_()
                return fn(int(bf16), *(t.data_ptr() for t in ptrs), fe, wpack.data_ptr(),
                          dms.data_ptr(), dts.data_ptr(), *(o.data_ptr() for o in outs), n,
                          stream)

            if call() != 0:
                raise RuntimeError(f"edge_block variant {label!r} failed to launch")
            torch.cuda.synchronize()
            err = rel_err((outs[0], outs[1], outs[2] - outs[3], outs[4]), want)
            ms = median_ms(call)
            print(f"[lab] edge_block_bwd {label}: {ms:.4f} ms (err {err:.1e}) "
                  f"[{resources(report, kernel)}]", flush=True)


def edge_fwd_lab(g, f32_variants: Dict[str, List[Edit]] = EDGE_FWD_F32) -> None:
    """The forward's variants, f32 (``edge_fwd_kernel``) and bf16
    (``edge_fwd_tc_kernel``), on the graph ``g``, built in one parallel pass."""
    built = build("edge_block", {**{f"f32: {k}": v for k, v in f32_variants.items()},
                                 **{f"bf16: {k}": v for k, v in EDGE_FWD.items()}}, "fwd")
    _, h, (W1, b1, W2, b2, Wg1, bg1, wg2) = edge_inputs(g)
    dev, H = g.device, ek.H
    n, fe = g.num_nodes, g.edge_attr.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    for bf16 in (False, True):
        mode, kernel = ("bf16", "edge_fwd_tc_kernel") if bf16 else ("f32", "edge_fwd_kernel")
        ud, us = ek.build_tables(h, W1, b1, bf16)
        wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
        want = ek.edge_block_fwd_plain(ud, us, g.coord, g.rowptr, g.src, g.edge_attr, wpack,
                                       bf16)
        outs = [torch.empty(shape, device=dev) for shape in ((n, H), (n, 3))]
        ptrs = (ud, us, g.coord, g.rowptr, g.src, g.edge_attr)
        for label, (lib, report) in built.items():
            if not label.startswith(mode + ": "):
                continue
            fn = lib.fastegnn_edge_fwd
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] + \
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]

            def call():
                return fn(int(bf16), *(t.data_ptr() for t in ptrs), fe, wpack.data_ptr(),
                          *(o.data_ptr() for o in outs), n, stream)

            if call() != 0:
                raise RuntimeError(f"edge_block variant {label!r} failed to launch")
            torch.cuda.synchronize()
            err = rel_err(outs, want)
            ms = median_ms(call)
            print(f"[lab] edge_block_fwd {label}: {ms:.4f} ms (err {err:.1e}) "
                  f"[{resources(report, kernel)}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_lab: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"[lab] {torch.cuda.get_device_name(0)}", flush=True)
    g, _, _ = build_batch(8000, 60, channels=3, seed=0, device="cuda")
    which = sys.argv[1:] or ["segment_sum", "edge_bwd", "edge_fwd"]
    labs = {"segment_sum": segment_sum_lab, "edge_bwd": edge_bwd_lab, "edge_fwd": edge_fwd_lab}
    for name in which:
        labs[name](g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
