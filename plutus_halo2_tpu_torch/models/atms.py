"""ATMS — the aggregate threshold multisignature circuits' STRUCTURE: the
port's copy of the gate, lookup and permutation layout of
``plutus_halo2_tpu/models/atms.py`` (``_main_gate_spec``, ``AtmsCircuit``,
``AtmsLookupCircuit``), the native equivalents of the reference's
AtmsSignatureCircuit / AtmsLookupCircuit (src/circuits/atms_circuit.rs,
src/circuits/atms_with_lookups_circuit.rs).

The statement, over the BLS12-381 scalar field: public inputs (pks_comm,
msg, threshold); the prover knows n Jubjub public keys and >= threshold
Schnorr signatures on msg such that pks_comm = Rescue(pk_1.u, ..., pk_n.u).
It is written on a halo2wrong-style main gate

    q_a a + q_b b + q_c c + q_d d + q_e e + q_ab ab + q_cd cd + q_const = 0

over 5 advice columns, with a PI gate q_pi * (a - I(x)) binding advice
cells to the instance column; the *_with_lookups variant adds a sixth
advice column of range-checked bits and a (tag, value) lookup.

The port verifies and never proves: ``plan_from_vk`` (``refimpl/keygen.py``)
needs only ``spec`` and ``num_public_inputs``, which do not depend on the
parties, so the witness code (``assign``, its row-emitting helper,
``prepare_test_signatures``) and the Jubjub and Rescue arithmetic they
need stay in the JAX package.
The constructor keeps the JAX one's signature; its arguments are stored
and not used.
"""

from __future__ import annotations

from ..refimpl.cs import ADVICE, CircuitSpec
from ..refimpl.field import Q
from .plan import ROT_CUR, e_add, e_const, e_mul, e_sub

# fixed-column indices
QA, QB, QC, QD, QE, QAB, QCD, QCONST, QPI, QTAG, QTVAL = range(11)
_ADV = 5


def _main_gate_spec(with_lookup: bool) -> CircuitSpec:
    # the lookup variant adds a dedicated advice column (index 5) holding only
    # range-checked bits (and zeros), so the whole-column lookup is sound
    n_adv = _ADV + 1 if with_lookup else _ADV
    spec = CircuitSpec(num_advice=n_adv, num_fixed=11, num_instance=1)
    a, b, c, d, e = (spec.query_advice(i, ROT_CUR) for i in range(_ADV))
    qs = [spec.query_fixed(i, ROT_CUR) for i in range(11)]
    main = e_add(
        e_mul(qs[QA], a),
        e_mul(qs[QB], b),
        e_mul(qs[QC], c),
        e_mul(qs[QD], d),
        e_mul(qs[QE], e),
        e_mul(qs[QAB], a, b),
        e_mul(qs[QCD], c, d),
        qs[QCONST],
    )
    spec.create_gate(main)
    spec.create_gate(e_mul(qs[QPI], e_sub(a, ("instance_col", 0))))
    if with_lookup:
        # slack bits range-checked against a (tag, value) table column pair
        # (reference atms_with_lookups_circuit.rs: one pow2range column)
        spec.add_lookup(
            [e_const(1), spec.query_advice(5, ROT_CUR)], [qs[QTAG], qs[QTVAL]]
        )
    for i in range(n_adv):
        spec.enable_equality(ADVICE, i)
    return spec


class AtmsCircuit:
    """t-of-n aggregate threshold multisignature verification circuit;
    public inputs [pks_comm, msg, threshold] (reference
    atms_circuit.rs:110-114). One construction serves every party count
    and threshold: the structure does not depend on the party data, which
    is stored and never read, so AtmsCircuit([(0, 1)] * 2, [None] * 2, 0, 1)
    gives the plan of the 408-party set as well."""

    num_public_inputs = 3
    with_lookup = False

    def __init__(self, pks, sigs, msg, threshold):
        """pks: [(u, v)] Jubjub points; sigs: [None | (R, s)] aligned with
        pks; msg: Fr; threshold: int <= #non-None sigs."""
        self.pks = pks
        self.sigs = sigs
        self.msg = msg % Q
        self.threshold = threshold
        self.spec = _main_gate_spec(self.with_lookup)


class AtmsLookupCircuit(AtmsCircuit):
    """ATMS + a range-check lookup column (the reference's
    atms_with_lookups_circuit.rs bolts one pow2range lookup column on)."""

    with_lookup = True
