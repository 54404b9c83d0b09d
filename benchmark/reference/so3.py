"""SO(3) machinery of the TFN reference: Clebsch-Gordan couplings in the
real spherical-harmonic basis and the real spherical harmonics.

A frozen copy of the port's plain numpy / PyTorch code
(``fastegnn_tpu_torch/models/tfn/so3.py``), which has no kernel, so that a
change to the program cannot change the reference.  Racah's formula for
the complex coefficients, turned into the real basis through the real <->
complex unitaries, in float64.  Real harmonics in the (m < 0: sine, m = 0,
m > 0: cosine) basis with the Condon-Shortley phase absorbed; degree 1 is
ordered (y, z, x).
"""

from __future__ import annotations

import functools
from math import factorial, sqrt

import numpy as np
import torch


def _wigner3j_m(j1, j2, j3, m1, m2, m3):
    """Racah's formula for <j1 m1 j2 m2 | j3 m3> (complex CG)."""
    if m1 + m2 != m3:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0

    def f(n):
        return factorial(int(n))

    pref = sqrt(
        (2 * j3 + 1)
        * f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
        / f(j1 + j2 + j3 + 1)
    )
    pref *= sqrt(
        f(j3 + m3) * f(j3 - m3)
        * f(j1 - m1) * f(j1 + m1) * f(j2 - m2) * f(j2 + m2)
    )
    s = 0.0
    for k in range(0, int(j1 + j2 - j3) + 1):
        denoms = [
            k,
            j1 + j2 - j3 - k,
            j1 - m1 - k,
            j2 + m2 - k,
            j3 - j2 + m1 + k,
            j3 - j1 - m2 + k,
        ]
        if any(d < 0 for d in denoms):
            continue
        s += (-1) ** k / np.prod([float(f(d)) for d in denoms])
    return pref * s


@functools.lru_cache(maxsize=None)
def clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """Complex CG tensor C[m1+j1, m2+j2, m3+j3] = <j1 m1 j2 m2 | j3 m3>."""
    out = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    for m1 in range(-j1, j1 + 1):
        for m2 in range(-j2, j2 + 1):
            for m3 in range(-j3, j3 + 1):
                out[m1 + j1, m2 + j2, m3 + j3] = _wigner3j_m(
                    j1, j2, j3, m1, m2, m3
                )
    return out


def _real_to_complex(l: int) -> np.ndarray:
    """Unitary U with Y_complex = U @ Y_real (standard real SH convention)."""
    s2 = 1.0 / sqrt(2.0)
    # row index = complex m, col index = real basis index
    U = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(1, l + 1):
        # complex m>0 row
        U[m + l, m + l] = (-1) ** m * s2          # cosine component
        U[m + l, -m + l] = -1j * (-1) ** m * s2   # sine component
        # complex -m row
        U[-m + l, m + l] = s2
        U[-m + l, -m + l] = 1j * s2
    U[l, l] = 1.0
    return U


@functools.lru_cache(maxsize=None)
def real_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """CG tensor in the *real* SH basis (float64), [2j1+1, 2j2+1, 2j3+1].

    Transforms the complex CG through the real<->complex unitaries; the
    result is purely real or purely imaginary depending on j1+j2+j3 parity —
    the nonzero part is returned (scale conventions are absorbed by learned
    radial weights).
    """
    C = clebsch_gordan(j1, j2, j3).astype(complex)
    U1, U2, U3 = (_real_to_complex(j) for j in (j1, j2, j3))
    # real-basis coupling: sum_M U1[M1,m1] U2[M2,m2] conj(U3[M3,m3]) C[M1,M2,M3]
    R = np.einsum("ab,cd,ef,ace->bdf", U1, U2, np.conj(U3), C)
    re, im = np.real(R), np.imag(R)
    if np.abs(im).max() > np.abs(re).max():
        out = im
    else:
        out = re
    assert min(np.abs(np.real(R)).max(), np.abs(np.imag(R)).max()) < 1e-10, (
        "real CG should be purely real or purely imaginary"
    )
    return out


def _assoc_legendre_all(l_max: int, x: torch.Tensor) -> dict:
    """All P_l^m(x) for 0 <= m <= l <= l_max by the stable recursions, as
    ``{(l, m): tensor}``; Condon-Shortley phase included."""
    P = {(0, 0): torch.ones_like(x)}
    somx2 = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    # diagonal: P_m^m = (-1)^m (2m-1)!! (1-x^2)^{m/2}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * somx2 * P[(m - 1, m - 1)]
    # subdiagonal: P_{m+1}^m = x (2m+1) P_m^m
    for m in range(0, l_max):
        P[(m + 1, m)] = x * (2 * m + 1) * P[(m, m)]
    # upward in l
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * x * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def real_sph_harm_all(l_max: int, vec: torch.Tensor, eps: float = 1e-12) -> dict:
    """Real spherical harmonics of the direction of ``vec`` [..., 3] (x, y,
    z): ``{l: [..., 2l+1]}`` in real-basis order m = -l..l (m < 0: sin
    |m| phi terms, m > 0: cos terms).  The squared norms are clamped at
    ``eps`` under both square roots, so a zero vector and an edge along z
    (``x = y = 0``) give finite values, the JAX function's."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(torch.clamp_min(x * x + y * y + z * z, eps))
    ct = z / r
    rxy = torch.sqrt(torch.clamp_min(x * x + y * y, eps))
    cphi = torch.where(rxy > eps, x / torch.clamp_min(rxy, eps), torch.ones_like(x))
    sphi = torch.where(rxy > eps, y / torch.clamp_min(rxy, eps), torch.zeros_like(y))

    P = _assoc_legendre_all(l_max, ct)
    # cos(m phi), sin(m phi) by angle-addition recursion
    cos_m = [torch.ones_like(cphi), cphi]
    sin_m = [torch.zeros_like(sphi), sphi]
    for m in range(2, l_max + 1):
        cos_m.append(cphi * cos_m[m - 1] - sphi * sin_m[m - 1])
        sin_m.append(sphi * cos_m[m - 1] + cphi * sin_m[m - 1])

    out = {}
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            norm = sqrt((2 * l + 1) / (4 * np.pi) * factorial(l - am) / factorial(l + am))
            base = norm * P[(l, am)]
            if m < 0:
                cols.append(sqrt(2.0) * (-1) ** am * base * sin_m[am])
            elif m == 0:
                cols.append(base)
            else:
                cols.append(sqrt(2.0) * (-1) ** am * base * cos_m[am])
        out[l] = torch.stack(cols, dim=-1)
    return out
