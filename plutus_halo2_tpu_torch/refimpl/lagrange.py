"""Lagrange-basis evaluation over Fr (executable spec): the port's copy of
``plutus_halo2_tpu/refimpl/lagrange.py``.

Mirrors the reference's LagrangePolynomialEvaluation.hs:37-118 /
lagrange.ak:40-130: barycentric-style evaluation of the Lagrange basis
l_i(x) at rotated omegas, and generic interpolation-evaluation for the
multiopen r(x) polynomials. Batch inversion follows the same Montgomery
trick the reference uses on-chain."""

from __future__ import annotations

from .field import Q, fr_batch_inv, fr_inv


def rotate_omega(omega: int, omega_inv: int, value: int, rotation: int) -> int:
    """value * omega^rotation (negative rotations use omega_inv)
    — BlsUtils.hs:58-64, omega_rotations.ak:18-29."""
    if rotation < 0:
        return value * pow(omega_inv, -rotation, Q) % Q
    return value * pow(omega, rotation, Q) % Q


def rotated_omegas(omega: int, omega_inv: int, start: int, end: int) -> list[int]:
    """[omega^i for i in start..end] inclusive (BlsUtils getRotatedOmegas)."""
    return [rotate_omega(omega, omega_inv, 1, i) for i in range(start, end + 1)]


def lagrange_polynomial_basis(
    x: int, xn: int, barycentric_weight: int, rotations: list[int]
) -> list[int]:
    """Evaluations of l_i(X) at x for each rotated omega w_i:
    l_i(x) = w_i * (x^n - 1) * n^{-1} / (x - w_i).
    LagrangePolynomialEvaluation.hs:37-58."""
    common = (xn - 1) * barycentric_weight % Q
    inverses = fr_batch_inv([(x - w) % Q for w in rotations])
    return [inv * common % Q * w % Q for inv, w in zip(inverses, rotations)]


def lagrange_evaluation(points: list[tuple[int, int]], x: int) -> int:
    """Interpolate through (xi, yi) and evaluate at x
    (LagrangePolynomialEvaluation.hs:86-118)."""
    acc = 0
    for xi, yi in points:
        num, den = 1, 1
        for xj, _ in points:
            if xj != xi:
                num = num * (x - xj) % Q
                den = den * (xi - xj) % Q
        acc = (acc + yi * num % Q * fr_inv(den)) % Q
    return acc


def powers(n: int, base: int) -> list[int]:
    """[1, b, b^2, ..., b^(n-1)] — BlsUtils.hs:44-51."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % Q
    return out
