"""Design comparisons of the port's segment-sum and bf16 edge-block kernels, on one GPU.

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
  wrong; only its time is read); the f32 forward, the one-warp-per-row
  design on the CUDA cores, is timed beside the bf16 forward.

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
Edit = Callable[[str], str]


def sub(old: str, new: str, after: str = "") -> Edit:
    """Replace ``old`` (which must occur after ``after``) by ``new``."""
    def edit(src: str) -> str:
        head, tail = src.split(after, 1) if after else ("", src)
        if old not in tail:
            raise ValueError(f"variant does not match the source: {old[:60]!r}")
        return head + after + tail.replace(old, new)
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


def edge_bwd_lab(g) -> None:
    libs = build("edge_block", EDGE_BWD, "bwd")
    gen, h, (W1, b1, W2, b2, Wg1, bg1, wg2) = edge_inputs(g)
    dev, H = g.device, ek.H
    n, fe = g.num_nodes, g.edge_attr.shape[1]
    dms = ek._rnd(torch.randn(n, H, generator=gen).to(dev), True).contiguous()
    dts = ek._rnd(torch.randn(n, 3, generator=gen).to(dev), True).contiguous()
    ud, us = ek.build_tables(h, W1, b1, True)
    wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, True)
    want = ek.edge_block_bwd_plain(ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr,
                                   wpack, dms, dts, True)
    outs = [torch.zeros(shape, device=dev) for shape in
            ((n, H), (n, H), (n, 3), (n, 3), (ek.PACK_ROWS, H))]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (ud, us, g.coord, g.rowptr, g.src, g.dst, g.edge_attr)
    for name, (lib, report) in libs.items():
        fn = lib.fastegnn_edge_bwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]

        def call():
            for o in outs:   # the wrapper zeroes its outputs too
                o.zero_()
            return fn(1, *(t.data_ptr() for t in ptrs), fe, wpack.data_ptr(), dms.data_ptr(),
                      dts.data_ptr(), *(o.data_ptr() for o in outs), n, stream)

        if call() != 0:
            raise RuntimeError(f"edge_block variant {name!r} failed to launch")
        torch.cuda.synchronize()
        err = rel_err((outs[0], outs[1], outs[2] - outs[3], outs[4]), want)
        ms = median_ms(call)
        print(f"[lab] edge_block_bwd bf16: {name}: {ms:.4f} ms (err {err:.1e}) "
              f"[{resources(report, 'edge_bwd_tc_kernel')}]", flush=True)


def edge_fwd_lab(g) -> None:
    libs = build("edge_block", EDGE_FWD, "fwd")
    _, h, (W1, b1, W2, b2, Wg1, bg1, wg2) = edge_inputs(g)
    dev, H = g.device, ek.H
    n, fe = g.num_nodes, g.edge_attr.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    for bf16 in (False, True):
        ud, us = ek.build_tables(h, W1, b1, bf16)
        wpack = ek.pack_weights(W1, W2, b2, Wg1, bg1, wg2, bf16)
        want = ek.edge_block_fwd_plain(ud, us, g.coord, g.rowptr, g.src, g.edge_attr, wpack,
                                       bf16)
        outs = [torch.empty(shape, device=dev) for shape in ((n, H), (n, 3))]
        ptrs = (ud, us, g.coord, g.rowptr, g.src, g.edge_attr)
        # f32: the one-warp-per-row kernel on the CUDA cores, committed source only
        variants = libs if bf16 else dict(list(libs.items())[:1])
        for name, (lib, report) in variants.items():
            fn = lib.fastegnn_edge_fwd
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] + \
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]

            def call():
                return fn(int(bf16), *(t.data_ptr() for t in ptrs), fe, wpack.data_ptr(),
                          *(o.data_ptr() for o in outs), n, stream)

            if call() != 0:
                raise RuntimeError(f"edge_block variant {name!r} failed to launch")
            torch.cuda.synchronize()
            err = rel_err(outs, want)
            ms = median_ms(call)
            mode, kernel = ("bf16", "edge_fwd_tc_kernel") if bf16 else ("f32", "edge_fwd_kernel")
            print(f"[lab] edge_block_fwd {mode}: {name}: {ms:.4f} ms (err {err:.1e}) "
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
