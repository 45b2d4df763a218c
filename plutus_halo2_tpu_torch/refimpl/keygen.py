"""Keygen: circuit spec + assignment -> proving key + CircuitPlan — the
port's copy of ``plutus_halo2_tpu/refimpl/keygen.py``.

Native replacement for the reference pipeline's `keygen_vk`/`keygen_pk`
(delegated to the halo2 fork at examples/simple_mul.rs:81-84) combined with
`extract_circuit` (src/plutus_gen/extraction/mod.rs:131-808): the output
CircuitPlan is the IR that drives both the spec verifier and the batched
verifier. ``keygen`` interpolates the fixed and permutation columns on the
device it is given (``refimpl/poly.py``: ``None`` is the card, ``"cpu"``
the kernels' plain versions); ``plan_from_vk`` builds a verification-only
plan without any of that work."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..models.plan import FLAVOR_HALO2, CircuitPlan, VerifyingKeyData
from ..models.verifier_torch import resolve_device
from .cs import Assignment, CircuitSpec
from .curve import g1_compress
from .field import Q, FR_DELTA, fr_inv
from .poly import domain_omega, lagrange_to_coeff
from .srs import TrapdoorSRS, get_or_create_srs


@dataclass
class ProvingKey:
    spec: CircuitSpec
    srs: TrapdoorSRS
    n: int
    k: int
    omega: int
    omega_inv: int
    blinding_factors: int
    fixed_values: list  # per fixed column, length n
    fixed_coeffs: list
    sigma_values: list  # per permutation column, length n
    sigma_coeffs: list
    assignment: Assignment


# the JAX ProvingKey's fields that proving_key_from_state reads, with "tau",
# its SRS's trapdoor
PK_STATE_KEYS = ("n", "k", "omega", "omega_inv", "blinding_factors", "fixed_values", "fixed_coeffs",
                 "sigma_values", "sigma_coeffs", "tau")


def _next_pow2_k(x: int) -> int:
    k = 0
    while (1 << k) < x:
        k += 1
    return k


def _sigma_columns(spec: CircuitSpec, asn: Assignment, n: int, usable: int):
    """Build permutation sigma column values: cycle structure from copy
    constraints, tags delta^col * omega^row (halo2 permutation keygen)."""
    cols = spec.equality_columns
    col_index = {c: i for i, c in enumerate(cols)}
    # mapping: successor pointers, cycle merge by swapping successors
    mapping = {}
    parent = {}

    def find(c):
        while parent[c] != c:
            parent[c] = parent[parent[c]]
            c = parent[c]
        return c

    for ci in range(len(cols)):
        for r in range(n):
            mapping[(ci, r)] = (ci, r)
            parent[(ci, r)] = (ci, r)

    for cell_a, cell_b in asn.copies:
        a = (col_index[(cell_a[0], cell_a[1])], cell_a[2])
        b = (col_index[(cell_b[0], cell_b[1])], cell_b[2])
        if a[1] >= usable or b[1] >= usable:
            raise ValueError("copy constraint in blinding region")
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        parent[ra] = rb
        mapping[a], mapping[b] = mapping[b], mapping[a]

    omega = domain_omega(_next_pow2_k(n))
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % Q
    delta_pows = [pow(FR_DELTA, i, Q) for i in range(len(cols))]
    sigmas = []
    for ci in range(len(cols)):
        col = [0] * n
        for r in range(n):
            tc, tr = mapping[(ci, r)]
            col[r] = delta_pows[tc] * omega_pows[tr] % Q
        sigmas.append(col)
    return sigmas


def _plan(vk: VerifyingKeyData, spec: CircuitSpec, flavor: str) -> CircuitPlan:
    return CircuitPlan(
        vk=vk,
        flavor=flavor,
        num_advice_columns=spec.num_advice,
        advice_queries=list(spec.advice_queries),
        fixed_queries=list(spec.fixed_queries),
        instance_queries=list(spec.instance_queries),
        gates=list(spec.gates),
        lookups=list(spec.lookups),
        num_permutation_sets=spec.num_permutation_sets(),
        permutation_columns=list(spec.equality_columns),
        chunk_len=spec.chunk_len(),
        num_vanishing_splits=spec.degree() - 1,
        degree=spec.degree(),
    ).finalize()


def plan_from_vk(circuit, vk: VerifyingKeyData,
                 flavor: str = FLAVOR_HALO2) -> CircuitPlan:
    """Verification-only CircuitPlan: circuit STRUCTURE (gates, queries,
    lookups, permutation layout — independent of witness values) + a
    committed VerifyingKeyData (e.g. utils.serialization.vk_from_json).
    Skips the SRS / assignment / commitment work of full keygen. The analog
    of the reference consuming its exported VK constants without re-running
    keygen (code_emitters_plinth.rs:786-888)."""
    spec: CircuitSpec = circuit.spec
    spec.finalize_queries()
    if spec.blinding_factors() != vk.blinding_factors:
        raise ValueError(
            f"circuit structure/blinding mismatch: spec {spec.blinding_factors()}"
            f" != vk {vk.blinding_factors}"
        )
    if circuit.num_public_inputs != vk.num_public_inputs:
        raise ValueError("circuit and vk disagree on the public-input count")
    return _plan(vk, spec, flavor)


def keygen(circuit, flavor: str = FLAVOR_HALO2, srs: TrapdoorSRS | None = None,
           min_k: int = 0, device=None):
    """Returns (ProvingKey, CircuitPlan). `circuit` provides `.spec`
    (CircuitSpec), `.assign(asn)` and `.num_public_inputs`."""
    device = resolve_device(device)
    spec: CircuitSpec = circuit.spec
    spec.finalize_queries()

    asn = Assignment(spec)
    circuit.assign(asn)

    bf = spec.blinding_factors()
    k = max(_next_pow2_k(asn.rows_used + bf + 1), min_k, 2)
    n = 1 << k
    usable = n - (bf + 1)
    if srs is None:
        srs = get_or_create_srs(k)

    omega = domain_omega(k)
    omega_inv = fr_inv(omega)

    fixed_values = asn.columns("fixed", n)
    fixed_coeffs = [lagrange_to_coeff(v, omega, device) for v in fixed_values]
    fixed_commitments = [srs.commit(c) for c in fixed_coeffs]

    sigma_values = _sigma_columns(spec, asn, n, usable)
    sigma_coeffs = [lagrange_to_coeff(v, omega, device) for v in sigma_values]
    sigma_commitments = [srs.commit(c) for c in sigma_coeffs]

    # vk.transcript_repr analog: domain-separated hash of the vk content
    h = hashlib.blake2b(digest_size=32)
    h.update(b"plutus-halo2-tpu-vk-v1")
    h.update(bytes([k]))
    for c in fixed_commitments + sigma_commitments:
        h.update(g1_compress(c))
    for g in spec.gates:
        h.update(repr(g).encode())
    transcript_repr = int.from_bytes(h.digest(), "little") % Q

    vk = VerifyingKeyData(
        fixed_commitments=fixed_commitments,
        permutation_commitments=sigma_commitments,
        omega=omega,
        omega_inv=omega_inv,
        barycentric_weight=fr_inv(n),
        n=n,
        k=k,
        blinding_factors=bf,
        transcript_repr=transcript_repr,
        s_g2=srs.s_g2,
        num_public_inputs=circuit.num_public_inputs,
    )

    pk = ProvingKey(
        spec=spec,
        srs=srs,
        n=n,
        k=k,
        omega=omega,
        omega_inv=omega_inv,
        blinding_factors=bf,
        fixed_values=fixed_values,
        fixed_coeffs=fixed_coeffs,
        sigma_values=sigma_values,
        sigma_coeffs=sigma_coeffs,
        assignment=asn,
    )
    return pk, _plan(vk, spec, flavor)


def proving_key_from_state(state: dict, circuit) -> ProvingKey:
    """A ProvingKey of the port that holds exactly the given values: the
    JAX ProvingKey's fields named in PK_STATE_KEYS (ints; lists of ints or
    numpy arrays per column; "tau": its SRS's trapdoor), with the structure
    and assignment of the port's `circuit`. The analog of
    ``TorchVerifier.from_jax_state``, so that one key proves in both
    packages."""
    missing = [k for k in PK_STATE_KEYS if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")

    def cols(v):
        return [[int(x) for x in c] for c in v]

    spec: CircuitSpec = circuit.spec
    spec.finalize_queries()
    asn = Assignment(spec)
    circuit.assign(asn)
    if spec.blinding_factors() != int(state["blinding_factors"]):
        raise ValueError("circuit structure and key disagree on the blinding factors")
    return ProvingKey(
        spec=spec,
        srs=TrapdoorSRS(int(state["tau"])),
        n=int(state["n"]),
        k=int(state["k"]),
        omega=int(state["omega"]),
        omega_inv=int(state["omega_inv"]),
        blinding_factors=int(state["blinding_factors"]),
        fixed_values=cols(state["fixed_values"]),
        fixed_coeffs=cols(state["fixed_coeffs"]),
        sigma_values=cols(state["sigma_values"]),
        sigma_coeffs=cols(state["sigma_coeffs"]),
        assignment=asn,
    )
