"""simple_mul's circuit structure for the benchmark's reference: the
halo2-book example (input-output-hk/plutus-halo2-verifier-gen,
src/circuits/simple_mul_circuit.rs:41-183; examples/simple_mul.rs): the gate
s_mul * (lhs * rhs - out) over 2 advice columns, a constants column and an
instance column with 3 public inputs. A frozen copy of the port's
``models/circuits.py::SimpleMulCircuit`` structure; it imports nothing of
the port."""

from __future__ import annotations

from portbench.reference.cs import ADVICE, FIXED, CircuitSpec
from portbench.reference.plan import ROT_CUR, ROT_NEXT, e_mul, e_sub

NUM_PUBLIC_INPUTS = 3


def spec() -> CircuitSpec:
    s = CircuitSpec(num_advice=2, num_fixed=2, num_instance=1)
    lhs = s.query_advice(0, ROT_CUR)
    rhs = s.query_advice(1, ROT_CUR)
    out = s.query_advice(0, ROT_NEXT)
    s_mul = s.query_fixed(1, ROT_CUR)
    s.create_gate(e_mul(s_mul, e_sub(e_mul(lhs, rhs), out)))
    s.enable_equality(ADVICE, 0)
    s.enable_equality(ADVICE, 1)
    s.enable_equality(FIXED, 0)  # the constants column
    return s
