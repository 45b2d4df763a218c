"""Circuit library — native equivalents of the reference's example circuits.

- SimpleMulCircuit: the halo2-book example (reference
  src/circuits/simple_mul_circuit.rs:41-183): gate s_mul*(lhs*rhs - out),
  2 advice columns, a constants column, an (unused) instance column; proves
  c = constant * a^2 * b^2.
- LookupRangeCircuit: pow2 range check via a tag/value lookup table
  (reference src/circuits/lookup_table_circuit.rs:33-153).
- MulChainCircuit: parameterizable multiplication-chain circuit used to scale
  row counts for benchmarking (stands in for the ATMS-scale circuits whose
  gate definitions live in the reference's external atms-halo2 crate).

Selectors are plain fixed columns (halo2 compresses simple selectors into
fixed columns at keygen; authoring them directly is equivalent)."""

from __future__ import annotations

from ..refimpl.cs import ADVICE, FIXED, Assignment, CircuitSpec
from ..refimpl.field import Q
from .plan import ROT_CUR, ROT_NEXT, e_const, e_mul, e_sub


class SimpleMulCircuit:
    """c = constant * a^2 * b^2 with public inputs [42, 42, 42] (unused, kept
    for parity with the reference example, examples/simple_mul.rs:92-95)."""

    num_public_inputs = 3

    def __init__(self, constant=7, a=2, b=3, c=None):
        self.constant = constant % Q
        self.a = a % Q
        self.b = b % Q
        self.c = c % Q if c is not None else constant * a * a % Q * b % Q * b % Q

        spec = CircuitSpec(num_advice=2, num_fixed=2, num_instance=1)
        lhs = spec.query_advice(0, ROT_CUR)
        rhs = spec.query_advice(1, ROT_CUR)
        out = spec.query_advice(0, ROT_NEXT)
        s_mul = spec.query_fixed(1, ROT_CUR)
        spec.create_gate(e_mul(s_mul, e_sub(e_mul(lhs, rhs), out)))
        spec.enable_equality(ADVICE, 0)
        spec.enable_equality(ADVICE, 1)
        spec.enable_equality(FIXED, 0)  # constants column
        self.spec = spec

    def assign(self, asn: Assignment):
        # private loads
        asn.assign_advice(0, 0, self.a)  # A
        asn.assign_advice(0, 1, self.b)  # B
        asn.assign_advice(0, 2, self.c)  # C
        # constant load: fixed constants column + copy into advice
        asn.assign_fixed(0, 3, self.constant)
        asn.assign_advice(0, 3, self.constant)
        asn.copy((FIXED, 0, 3), (ADVICE, 0, 3))

        def mul(row, lhs_cell, rhs_cell, lhs_val, rhs_val):
            asn.assign_fixed(1, row, 1)  # s_mul
            asn.assign_advice(0, row, lhs_val)
            asn.assign_advice(1, row, rhs_val)
            asn.copy(lhs_cell, (ADVICE, 0, row))
            asn.copy(rhs_cell, (ADVICE, 1, row))
            out_val = lhs_val * rhs_val % Q
            asn.assign_advice(0, row + 1, out_val)
            return (ADVICE, 0, row + 1), out_val

        ab_cell, ab = mul(4, (ADVICE, 0, 0), (ADVICE, 0, 1), self.a, self.b)
        absq_cell, absq = mul(6, ab_cell, ab_cell, ab, ab)
        out_cell, _out = mul(8, (ADVICE, 0, 3), absq_cell, self.constant, absq)
        # assert equality with loaded c
        asn.copy(out_cell, (ADVICE, 0, 2))


class LookupRangeCircuit:
    """Range-check advice values below 2^bits via a (tag, value) lookup table
    (reference lookup_table_circuit.rs:60-99: per-column tag, table enumerates
    all values < 2^bits per tag)."""

    num_public_inputs = 1

    def __init__(self, values=(3, 9, 14), bits=4, num_cols=2):
        self.values = [v % Q for v in values]
        self.bits = bits
        self.num_cols = num_cols

        # fixed: 0 = t_tag, 1 = t_val
        spec = CircuitSpec(num_advice=num_cols, num_fixed=2, num_instance=1)
        t_tag = spec.query_fixed(0, ROT_CUR)
        t_val = spec.query_fixed(1, ROT_CUR)
        for col in range(num_cols):
            a = spec.query_advice(col, ROT_CUR)
            spec.add_lookup([e_const(col + 1), a], [t_tag, t_val])
        spec.enable_equality(ADVICE, 0)
        self.spec = spec

    def assign(self, asn: Assignment):
        # table rows: per column tag, all values < 2^bits
        row = 0
        for col in range(self.num_cols):
            for v in range(1 << self.bits):
                asn.assign_fixed(0, row, col + 1)
                asn.assign_fixed(1, row, v)
                row += 1
        # witness values in every advice column (unassigned rows default to 0,
        # which the table covers for every tag)
        for col in range(self.num_cols):
            for i, v in enumerate(self.values):
                asn.assign_advice(col, i, v)
        asn.rows_used = max(asn.rows_used, row)


class MulChainCircuit:
    """length-L multiplication chain: out_{i+1} = out_i * out_i + w_i.
    Scales rows/evals for benchmarking larger verification workloads."""

    num_public_inputs = 1

    def __init__(self, start=3, length=64):
        self.start = start % Q
        self.length = length

        spec = CircuitSpec(num_advice=2, num_fixed=1, num_instance=1)
        lhs = spec.query_advice(0, ROT_CUR)
        rhs = spec.query_advice(1, ROT_CUR)
        out = spec.query_advice(0, ROT_NEXT)
        s = spec.query_fixed(0, ROT_CUR)
        spec.create_gate(e_mul(s, e_sub(e_mul(lhs, rhs), out)))
        spec.enable_equality(ADVICE, 0)
        spec.enable_equality(ADVICE, 1)
        self.spec = spec

    def assign(self, asn: Assignment):
        v = self.start
        asn.assign_advice(0, 0, v)
        row = 0
        for _ in range(self.length):
            asn.assign_fixed(0, row, 1)
            asn.assign_advice(1, row, v)
            asn.copy((ADVICE, 0, row), (ADVICE, 1, row))
            v = v * v % Q
            asn.assign_advice(0, row + 1, v)
            row += 1
