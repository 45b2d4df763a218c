"""atms_with_lookups_50_90's circuit structure for the benchmark's
reference: the aggregate threshold multisignature circuit with its range
lookup (input-output-hk/plutus-halo2-verifier-gen,
src/circuits/atms_with_lookups_circuit.rs:21-316): a halo2wrong-style main
gate q_a a + q_b b + q_c c + q_d d + q_e e + q_ab ab + q_cd cd + q_const over
5 advice columns, a public-input gate q_pi (a - I(x)), and one lookup of the
dedicated bit column (advice 5) against a (tag, value) table. The
structure does not depend on the parties, so it is the 90-party,
threshold-50 set's. A frozen copy of the port's
``models/atms.py::_main_gate_spec(with_lookup=True)``; it imports nothing of
the port."""

from __future__ import annotations

from portbench.reference.cs import ADVICE, CircuitSpec
from portbench.reference.plan import ROT_CUR, e_add, e_const, e_mul, e_sub

NUM_PUBLIC_INPUTS = 3  # pks_comm, msg, threshold
QA, QB, QC, QD, QE, QAB, QCD, QCONST, QPI, QTAG, QTVAL = range(11)
MAIN_ADVICE = 5


def spec() -> CircuitSpec:
    s = CircuitSpec(num_advice=MAIN_ADVICE + 1, num_fixed=11, num_instance=1)
    a, b, c, d, e = (s.query_advice(i, ROT_CUR) for i in range(MAIN_ADVICE))
    qs = [s.query_fixed(i, ROT_CUR) for i in range(11)]
    s.create_gate(e_add(
        e_mul(qs[QA], a), e_mul(qs[QB], b), e_mul(qs[QC], c), e_mul(qs[QD], d), e_mul(qs[QE], e),
        e_mul(qs[QAB], a, b), e_mul(qs[QCD], c, d), qs[QCONST]))
    s.create_gate(e_mul(qs[QPI], e_sub(a, ("instance_col", 0))))
    s.add_lookup([e_const(1), s.query_advice(5, ROT_CUR)], [qs[QTAG], qs[QTVAL]])
    for i in range(MAIN_ADVICE + 1):
        s.enable_equality(ADVICE, i)
    return s
