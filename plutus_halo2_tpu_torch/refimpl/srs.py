"""KZG structured reference string (testing trapdoor form) + params cache:
the port's copy of ``plutus_halo2_tpu/refimpl/srs.py`` (the same tau from
the same seed, the same ``kzg_params/`` cache files).

Replaces the reference's `kzg_params.rs` get-or-create flow. Like the
reference's `unsafe_setup` (kzg_params.rs:36-38: "generated parameters are
unsafe and should only be used for testing purposes"), this SRS is for tests
and fixture generation only: we keep the trapdoor tau and commit to a
polynomial by evaluating it at tau — mathematically identical to committing
against the monomial SRS, without materializing 2^k G1 points."""

from __future__ import annotations

import hashlib
import json
import os

from .field import Q, fr_inv
from .curve import G1_GEN, G2_GEN, g1_mul, g2_mul, g2_compress
from .poly import poly_eval

SRS_CACHE_DIR = "kzg_params"


class TrapdoorSRS:
    def __init__(self, tau: int):
        self.tau = tau % Q
        self.s_g2 = g2_mul(G2_GEN, self.tau)
        self.g2 = G2_GEN

    @classmethod
    def from_seed(cls, seed: bytes = b"plutus-halo2-tpu-test-srs"):
        tau = int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(), "little") % Q
        return cls(tau)

    def commit(self, coeffs: list[int]):
        """Commitment to the polynomial with the given coefficients."""
        return g1_mul(G1_GEN, poly_eval(coeffs, self.tau))

    def commit_eval(self, value_at_tau: int):
        return g1_mul(G1_GEN, value_at_tau % Q)


def get_or_create_srs(k: int, cache_dir: str = SRS_CACHE_DIR) -> TrapdoorSRS:
    """Get-or-create cache keyed by k (mirrors get_or_create_kzg_params,
    kzg_params.rs:31-42). The trapdoor itself is cached — test-only."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"kzg_params_{k}.json")
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        return TrapdoorSRS(int(data["tau"], 16))
    srs = TrapdoorSRS.from_seed(f"k={k}".encode())
    with open(path, "w") as f:
        json.dump({"tau": hex(srs.tau), "s_g2": g2_compress(srs.s_g2).hex()}, f)
    return srs
