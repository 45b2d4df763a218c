"""Circuit specification model (the benchmark's frozen copy of
``plutus_halo2_tpu_torch/refimpl/cs.py``, structure only).

Circuits are authored against this API (column allocation, gate expressions
over queried cells, lookups, equality/copy constraints), like the reference's
circuits are authored against halo2's (src/circuits/*.rs). Selectors are
modeled directly as fixed columns (halo2 compresses simple selectors into
fixed columns at keygen anyway).

Query registration order follows halo2: queries get indices in first-use
order; every equality column is guaranteed a cur-rotation query (halo2 keygen
does the same so the permutation argument can reference column evaluations).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .plan import ROT_CUR, expr_degree

ADVICE = "advice"
FIXED = "fixed"
INSTANCE = "instance"


@dataclass
class CircuitSpec:
    num_advice: int
    num_fixed: int
    num_instance: int = 1

    advice_queries: list = field(default_factory=list)  # [(col, rot)]
    fixed_queries: list = field(default_factory=list)
    instance_queries: list = field(default_factory=list)
    gates: list = field(default_factory=list)  # [Expr]
    lookups: list = field(default_factory=list)  # [(input_exprs, table_exprs)]
    equality_columns: list = field(default_factory=list)  # [(kind, col)]

    # -- query registration (returns DSL atoms) -----------------------------
    def query_advice(self, col: int, rot: str = ROT_CUR):
        assert 0 <= col < self.num_advice
        key = (col, rot)
        if key not in self.advice_queries:
            self.advice_queries.append(key)
        return ("advice", self.advice_queries.index(key))

    def query_fixed(self, col: int, rot: str = ROT_CUR):
        assert 0 <= col < self.num_fixed
        key = (col, rot)
        if key not in self.fixed_queries:
            self.fixed_queries.append(key)
        return ("fixed", self.fixed_queries.index(key))

    def query_instance(self, col: int, rot: str = ROT_CUR):
        assert 0 <= col < self.num_instance
        key = (col, rot)
        if key not in self.instance_queries:
            self.instance_queries.append(key)
        return ("instance", self.instance_queries.index(key))

    def create_gate(self, expr):
        self.gates.append(expr)

    def add_lookup(self, input_exprs, table_exprs):
        assert len(input_exprs) == len(table_exprs)
        self.lookups.append((list(input_exprs), list(table_exprs)))

    def enable_equality(self, kind: str, col: int):
        if (kind, col) not in self.equality_columns:
            self.equality_columns.append((kind, col))

    # -- derived parameters (halo2 ConstraintSystem analogs) ----------------
    def finalize_queries(self):
        """Ensure every equality column has a cur query (halo2 keygen does the
        same so permutation terms can reference evaluations)."""
        for kind, col in self.equality_columns:
            if kind == ADVICE:
                self.query_advice(col, ROT_CUR)
            elif kind == FIXED:
                self.query_fixed(col, ROT_CUR)
            # instance columns use the directly computed instance_eval

    def degree(self) -> int:
        """Max constraint degree (halo2 ConstraintSystem::degree): permutation
        needs 3; each lookup needs max(4, 2 + deg_in + deg_table); gates their
        own degree. chunk_len = degree - 2 (extract_circuit, mod.rs:139)."""
        deg = 3 if self.equality_columns else 1
        for inputs, tables in self.lookups:
            d_in = max((expr_degree(e) for e in inputs), default=1)
            d_t = max((expr_degree(e) for e in tables), default=1)
            deg = max(deg, max(4, 2 + d_in + d_t))
        for g in self.gates:
            deg = max(deg, expr_degree(g))
        return deg

    def blinding_factors(self) -> int:
        """halo2 ConstraintSystem::blinding_factors: max distinct rotations on
        any advice column (>=3), +1 multiopen, +1 safety."""
        per_col = {}
        for col, rot in self.advice_queries:
            per_col.setdefault(col, set()).add(rot)
        factors = max((len(v) for v in per_col.values()), default=1)
        return max(3, factors) + 2

    def chunk_len(self) -> int:
        return self.degree() - 2

    def num_permutation_sets(self) -> int:
        if not self.equality_columns:
            return 0
        c = self.chunk_len()
        return (len(self.equality_columns) + c - 1) // c
