"""The port's host library (``fastegnn_tpu_torch.native``) against the JAX
package's (``fastegnn_tpu.native``): the same outputs, bit for bit and in
the same order, and its own plain versions."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastegnn_tpu import native as jnative
from fastegnn_tpu_torch import native as pnative
from fastegnn_tpu_torch.ops import _cuda_build


def _grid(spacing: float, n: int = 6) -> np.ndarray:
    axes = np.arange(n, dtype=np.float32) * np.float32(spacing)
    return np.stack(np.meshgrid(axes, axes, axes, indexing="ij"), -1).reshape(-1, 3)


def _cloud(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.random((600, 3)).astype(np.float32)
    if kind == "normal":
        return rng.normal(size=(300, 3)).astype(np.float32)
    if kind == "coincident":   # every point three times, and a few more at one spot
        pts = np.repeat(rng.random((80, 3)).astype(np.float32), 3, axis=0)
        return np.concatenate([pts, np.full((4, 3), 0.5, np.float32)])
    if kind == "grid":         # neighbours at exactly 0.25, exact in f32
        return _grid(0.25)
    if kind == "one point":
        return np.zeros((1, 3), np.float32)
    return np.zeros((0, 3), np.float32)


@pytest.mark.parametrize("kind,r", [
    ("uniform", 0.12), ("normal", 0.7), ("coincident", 0.15),
    ("grid", 0.25), ("grid", float(np.nextafter(np.float32(0.25), np.float32(1)))),
    ("one point", 0.1), ("empty", 0.1)])
def test_radius_graph_matches_jax_in_order(kind, r):
    loc = _cloud(kind)
    want, got = jnative.radius_graph(loc, r), pnative.radius_graph(loc, r)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if kind == "grid":   # pairs at exactly r are left out, those just inside kept
        assert got[0].size == (0 if r == 0.25 else 2 * 3 * 5 * 36)
    if kind == "coincident":   # no edge between coincident points
        d2 = ((loc[got[0]] - loc[got[1]]) ** 2).sum(-1)
        assert got[0].size and (d2 > 0).all()


def test_radius_graph_rounds_d2_as_jax_at_the_radius():
    """Pairs whose f32 ``d^2`` rounds differently with and without fused
    multiply-adds, each at a radius with ``r^2`` equal to the larger of the
    two: both libraries keep or drop each pair alike."""
    rng = np.random.default_rng(1)
    loc = (rng.random((4000, 2, 3)) * 3).astype(np.float32)
    dd = loc[:, 0] - loc[:, 1]
    unfused = (dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2]
    f64 = dd.astype(np.float64)
    inner = (f64[:, 0] ** 2 + (dd[:, 1] * dd[:, 1]).astype(np.float64)).astype(np.float32)
    fused = (f64[:, 2] ** 2 + inner.astype(np.float64)).astype(np.float32)
    hi = np.maximum(fused, unfused)
    r = np.sqrt(hi.astype(np.float64)).astype(np.float32)
    cases = np.flatnonzero((fused != unfused) & (r * r == hi))
    assert cases.size > 50
    for k in cases[:200]:
        got, want = pnative.radius_graph(loc[k], r[k]), jnative.radius_graph(loc[k], r[k])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "out of range", "empty", "one bin"])
def test_counting_argsort_and_bincount_match_jax(kind):
    rng = np.random.default_rng(2)
    n_bins = 97
    keys = {"random": rng.integers(0, n_bins, 5000),
            "out of range": rng.integers(-5, n_bins + 5, 5000),
            "empty": np.zeros(0),
            "one bin": np.full(300, 3)}[kind].astype(np.int32)
    perm = pnative.counting_argsort(keys, n_bins)
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, jnative.counting_argsort(keys, n_bins))
    np.testing.assert_array_equal(perm, pnative.counting_argsort_plain(keys, n_bins))
    counts = pnative.bincount_f32(keys, n_bins)
    assert counts.dtype == np.float32 and counts.shape == (n_bins,)
    np.testing.assert_array_equal(counts, jnative.bincount_f32(keys, n_bins))
    np.testing.assert_array_equal(counts, pnative.bincount_f32_plain(keys, n_bins))


def test_radius_graph_matches_its_plain_version():
    loc = _cloud("uniform")
    r = 0.12
    d = np.linalg.norm(loc[:, None].astype(np.float64) - loc[None], axis=-1)
    assert np.abs(d - r).min() > 1e-6   # no pair where f32 and f64 could disagree
    dst, src = pnative.radius_graph(loc, r)
    order = np.lexsort((src, dst))
    for a, b in zip((dst[order], src[order]), pnative.radius_graph_plain(loc, r)):
        np.testing.assert_array_equal(a, b)


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_LIBS", {})
    monkeypatch.setattr(pnative, "_LIB", None)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_cuda_build, "GXX", "g++-not-installed")
    with pytest.raises(RuntimeError, match="g\\+\\+-not-installed not found"):
        pnative.counting_argsort(np.zeros(3, np.int32), 2)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "graphcore.cpp"
    bad.write_text("extern \"C\" int broken( {\n")
    monkeypatch.setattr(_cuda_build, "HOST_SOURCES", {"graphcore": bad})
    with pytest.raises(RuntimeError, match="(?s)graphcore.cpp.*error"):
        pnative.bincount_f32(np.zeros(3, np.int32), 2)


def test_native_runs_without_jax():
    repo = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['fastegnn_tpu'] = None\n"
            "import numpy as np\n"
            "from fastegnn_tpu_torch import native\n"
            "dst, src = native.radius_graph(np.random.default_rng(0).random((50, 3)), 0.3)\n"
            "assert dst.size and native.counting_argsort(dst, 50).size == dst.size\n"
            "bad = [m for m in sys.modules if m.startswith(('jax.', 'fastegnn_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(repo))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
