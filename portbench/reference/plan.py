"""CircuitPlan — the circuit-specialized verification IR.

The benchmark's frozen copy of ``plutus_halo2_tpu_torch/models/plan.py``. Analog of the
reference's ``CircuitRepresentation`` (src/plutus_gen/extraction/data.rs:307-328)
and of ``extract_circuit`` (src/plutus_gen/extraction/mod.rs:131-808). Where the
reference compiles this IR into Plinth/Aiken source via Handlebars templates,
the batched verifier interprets it when it is built: every count and every
ordering below is static per circuit.

The expression DSL mirrors ``ScalarExpression`` (data.rs:284-296) plus the
domain-level atoms needed to evaluate the same expressions as polynomials on
the prover side (identity column, Lagrange selectors). One expression list,
two interpreters: scalar (verifier, refimpl + JAX) and row-vector (prover).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# rotations — RotationDescription (data.rs:85-92)
ROT_CUR = "cur"
ROT_NEXT = "next"
ROT_PREV = "prev"
ROT_LAST = "last"  # -(blinding_factors + 1)

ROT_OFFSETS = {ROT_PREV: -1, ROT_CUR: 0, ROT_NEXT: 1}


def rot_offset(rot: str, blinding_factors: int) -> int:
    if rot == ROT_LAST:
        return -(blinding_factors + 1)
    return ROT_OFFSETS[rot]


# ---------------------------------------------------------------------------
# Expression DSL (tuple-encoded for hashability / zero deps)
# ---------------------------------------------------------------------------
# ('const', int) | ('var', name) | ('neg', e) | ('add', a, b) | ('mul', a, b)
# | ('pow', e, k)
# | ('advice', query_idx) | ('fixed', query_idx) | ('instance', query_idx)
# | ('perm_common', idx)          # sigma_i evaluation (1-based idx)
# | ('perm_z', set_idx, which)    # which in {'cur','next','last'} (z evals)
# | ('lookup', arg_idx, which)    # which in {'z_cur','z_next','a_cur','a_prev','s_cur'}
# | ('identity',)                 # the evaluation point X itself
# | ('l0',) | ('l_last',) | ('l_active',)

def e_const(v):
    return ("const", v)


def e_var(n):
    return ("var", n)


def e_neg(a):
    return ("neg", a)


def e_add(*args):
    acc = args[0]
    for a in args[1:]:
        acc = ("add", acc, a)
    return acc


def e_sub(a, b):
    return ("add", a, ("neg", b))


def e_mul(*args):
    acc = args[0]
    for a in args[1:]:
        acc = ("mul", acc, a)
    return acc


def e_pow(a, k):
    return ("pow", a, k)


def eval_expr(expr, env):
    """Evaluate an expression against an environment.

    env must provide: ``const(v)``, ``var(name)``, ``advice(i)``, ``fixed(i)``,
    ``instance(i)``, ``perm_common(i)``, ``perm_z(s, which)``,
    ``lookup(i, which)``, ``identity()``, ``l0()``, ``l_last()``,
    ``l_active()`` and the ring ops ``add/mul/neg/pow``."""
    tag = expr[0]
    if tag == "const":
        return env.const(expr[1])
    if tag == "var":
        return env.var(expr[1])
    if tag == "neg":
        return env.neg(eval_expr(expr[1], env))
    if tag == "add":
        return env.add(eval_expr(expr[1], env), eval_expr(expr[2], env))
    if tag == "mul":
        return env.mul(eval_expr(expr[1], env), eval_expr(expr[2], env))
    if tag == "pow":
        return env.pow(eval_expr(expr[1], env), expr[2])
    if tag == "advice":
        return env.advice(expr[1])
    if tag == "fixed":
        return env.fixed(expr[1])
    if tag == "instance":
        return env.instance(expr[1])
    if tag == "instance_col":
        return env.instance_col(expr[1])
    if tag == "perm_common":
        return env.perm_common(expr[1])
    if tag == "perm_z":
        return env.perm_z(expr[1], expr[2])
    if tag == "lookup":
        return env.lookup(expr[1], expr[2])
    if tag == "identity":
        return env.identity()
    if tag == "l0":
        return env.l0()
    if tag == "l_last":
        return env.l_last()
    if tag == "l_active":
        return env.l_active()
    raise ValueError(f"unknown expression node {tag}")


def expr_degree(expr, query_rot=None) -> int:
    """Multiplicative degree of an expression in the column polynomials
    (used for quotient sizing, cf. halo2 Expression::degree)."""
    tag = expr[0]
    if tag in ("const", "var"):
        return 0
    if tag in ("advice", "fixed", "instance", "instance_col", "perm_common", "perm_z", "lookup", "identity", "l0", "l_last", "l_active"):
        return 1
    if tag == "neg":
        return expr_degree(expr[1])
    if tag == "add":
        return max(expr_degree(expr[1]), expr_degree(expr[2]))
    if tag == "mul":
        return expr_degree(expr[1]) + expr_degree(expr[2])
    if tag == "pow":
        return expr_degree(expr[1]) * expr[2]
    raise ValueError(tag)


# ---------------------------------------------------------------------------
# Queries and commitment references (data.rs:228-281)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Query:
    commitment: tuple  # tagged ref, e.g. ('advice_com', col), ('fixed_com', i), ...
    evaluation: tuple  # tagged ref, e.g. ('advice_eval', q), ('perm_z', s, 'cur')
    rot: str


# proof extraction step tags (data.rs:7-44); (tag, count) run-length encoded
STEP_ADVICE_COMMITMENTS = "advice_commitments"
STEP_THETA = "theta"
STEP_LOOKUP_PERMUTED = "lookup_permuted"
STEP_BETA = "beta"
STEP_GAMMA = "gamma"
STEP_PERMUTATION_COMMITTED = "permutation_committed"
STEP_LOOKUP_COMMITMENT = "lookup_commitment"
STEP_VANISHING_RAND = "vanishing_rand"
STEP_Y = "y"
STEP_VANISHING_SPLIT = "vanishing_split"
STEP_X = "x"
STEP_ADVICE_EVAL = "advice_eval"
STEP_FIXED_EVAL = "fixed_eval"
STEP_RANDOM_EVAL = "random_eval"
STEP_PERMUTATION_COMMON = "permutation_common"
STEP_PERMUTATION_EVAL = "permutation_eval"  # payload: (set_idx, has_last)
STEP_LOOKUP_EVAL = "lookup_eval"
# halo2-book multiopen tail
STEP_X1 = "x1"
STEP_X2 = "x2"
STEP_F_COMMITMENT = "f_commitment"
STEP_X3 = "x3"
STEP_Q_EVALS = "q_evals"
STEP_X4 = "x4"
STEP_PI = "pi"
# GWC19 tail
STEP_V = "v"
STEP_WITNESSES = "witnesses"
STEP_U = "u"

FLAVOR_HALO2 = "halo2"  # KZGCommitmentScheme — book multiopen
FLAVOR_GWC = "gwc19"  # GwcKZGCommitmentScheme


@dataclass
class VerifyingKeyData:
    """InstantiationSpecificData analog (data.rs:46-76)."""

    fixed_commitments: list  # affine G1 tuples
    permutation_commitments: list
    omega: int
    omega_inv: int
    barycentric_weight: int  # n^{-1}
    n: int
    k: int
    blinding_factors: int
    transcript_repr: int
    s_g2: Any  # affine G2
    num_public_inputs: int


@dataclass
class CircuitPlan:
    vk: VerifyingKeyData
    flavor: str

    # static circuit structure
    num_advice_columns: int
    advice_queries: list  # [(col, rot_str)] in halo2 query order
    fixed_queries: list  # [(col, rot_str)]
    instance_queries: list
    gates: list  # [Expr] over query indices
    lookups: list  # [(input_exprs, table_exprs)] per argument
    num_permutation_sets: int
    permutation_columns: list  # [('advice'|'fixed'|'instance', col)] in chunk order
    chunk_len: int
    num_vanishing_splits: int
    degree: int

    # derived query/multiopen structure (filled by finalize())
    queries_perm: list = field(default_factory=list)
    queries_common: list = field(default_factory=list)
    queries_vanishing: list = field(default_factory=list)
    queries_lookup: list = field(default_factory=list)
    queries_advice: list = field(default_factory=list)
    queries_fixed: list = field(default_factory=list)
    point_sets: list = field(default_factory=list)  # list of rot-str lists
    commitment_data: list = field(default_factory=list)  # [(com_ref, set_idx, rots, eval_refs)]
    rotation_order: list = field(default_factory=list)  # first-occurrence rot order (GWC)
    steps: list = field(default_factory=list)  # [(tag, payload)]
    x1_powers_count: int = 0
    x4_powers_count: int = 0

    # ------------------------------------------------------------------
    def finalize(self):
        """Derive queries, point sets, proof-walk steps — the trace-time
        equivalent of extract_circuit + precompute_intermediate_sets
        (extraction/mod.rs:131-877)."""
        self.queries_advice = [
            Query(("advice_com", col), ("advice_eval", qi), rot)
            for qi, (col, rot) in enumerate(self.advice_queries)
        ]
        self.queries_fixed = [
            Query(("fixed_com", col), ("fixed_eval", qi), rot)
            for qi, (col, rot) in enumerate(self.fixed_queries)
        ]
        # permutation z queries: cur+next per set, then `last` for all but the
        # final set, pushed in REVERSE set order (extraction/mod.rs:726-745)
        self.queries_perm = []
        for s in range(self.num_permutation_sets):
            self.queries_perm.append(Query(("perm_z_com", s), ("perm_z", s, "cur"), ROT_CUR))
            self.queries_perm.append(Query(("perm_z_com", s), ("perm_z", s, "next"), ROT_NEXT))
        for s in range(self.num_permutation_sets - 2, -1, -1):
            self.queries_perm.append(Query(("perm_z_com", s), ("perm_z", s, "last"), ROT_LAST))
        self.queries_common = [
            Query(("perm_common_com", i), ("perm_common", i), ROT_CUR)
            for i in range(len(self.permutation_columns))
        ]
        self.queries_vanishing = [
            Query(("vanishing_g",), ("vanishing_s",), ROT_CUR),
            Query(("vanishing_rand",), ("random_eval",), ROT_CUR),
        ]
        self.queries_lookup = []
        for i in range(len(self.lookups)):
            self.queries_lookup.extend(
                [
                    Query(("lookup_z_com", i), ("lookup", i, "z_cur"), ROT_CUR),
                    Query(("lookup_perm_input_com", i), ("lookup", i, "a_cur"), ROT_CUR),
                    Query(("lookup_perm_table_com", i), ("lookup", i, "s_cur"), ROT_CUR),
                    Query(("lookup_perm_input_com", i), ("lookup", i, "a_prev"), ROT_PREV),
                    Query(("lookup_z_com", i), ("lookup", i, "z_next"), ROT_NEXT),
                ]
            )
        self._compute_point_sets()
        self._compute_rotation_order()
        self._compute_steps()
        return self

    def all_queries_ordered(self):
        """halo2 query order: ADVICE, PERMUTATION, LOOKUP, FIXED, COMMON,
        VANISHING (data.rs:330-348)."""
        return (
            self.queries_advice
            + self.queries_perm
            + self.queries_lookup
            + self.queries_fixed
            + self.queries_common
            + self.queries_vanishing
        )

    def _compute_point_sets(self):
        """precompute_intermediate_sets (extraction/mod.rs:810-877):
        group queries by commitment (insertion order), dedup point lists."""
        order: list = []
        by_com: dict = {}
        for q in self.all_queries_ordered():
            if q.commitment not in by_com:
                by_com[q.commitment] = []
                order.append(q.commitment)
            by_com[q.commitment].append(q)
        unique_sets: list = []
        set_index: dict = {}
        com_data = []
        for com in order:
            rots = []
            for q in by_com[com]:
                if q.rot not in rots:
                    rots.append(q.rot)
            key = tuple(rots)
            if key not in set_index:
                set_index[key] = len(unique_sets)
                unique_sets.append(list(rots))
            com_data.append(
                (com, set_index[key], [q.rot for q in by_com[com]], [q.evaluation for q in by_com[com]])
            )
        self.point_sets = unique_sets
        self.commitment_data = com_data
        max_commitments_per_set = max(
            (sum(1 for cd in com_data if cd[1] == i) for i in range(len(unique_sets))),
            default=0,
        )
        self.x1_powers_count = max_commitments_per_set
        self.x4_powers_count = len(unique_sets) + 1

    def _compute_rotation_order(self):
        """First-occurrence rotation order over all queries — drives GWC19
        witness grouping (code_emitters_plinth.rs:621-642)."""
        order = []
        for q in self.all_queries_ordered():
            if q.rot not in order:
                order.append(q.rot)
        self.rotation_order = order

    def _compute_steps(self):
        """The ProofExtractionSteps sequence (extraction/mod.rs:175-351 +
        flavor tails at :38-124)."""
        steps: list = []
        steps.append((STEP_ADVICE_COMMITMENTS, self.num_advice_columns))
        steps.append((STEP_THETA, 1))
        if self.lookups:
            steps.append((STEP_LOOKUP_PERMUTED, len(self.lookups)))
        steps.append((STEP_BETA, 1))
        steps.append((STEP_GAMMA, 1))
        steps.append((STEP_PERMUTATION_COMMITTED, self.num_permutation_sets))
        if self.lookups:
            steps.append((STEP_LOOKUP_COMMITMENT, len(self.lookups)))
        steps.append((STEP_VANISHING_RAND, 1))
        steps.append((STEP_Y, 1))
        steps.append((STEP_VANISHING_SPLIT, self.num_vanishing_splits))
        steps.append((STEP_X, 1))
        steps.append((STEP_ADVICE_EVAL, len(self.advice_queries)))
        steps.append((STEP_FIXED_EVAL, len(self.fixed_queries)))
        steps.append((STEP_RANDOM_EVAL, 1))
        steps.append((STEP_PERMUTATION_COMMON, len(self.permutation_columns)))
        for s in range(self.num_permutation_sets):
            has_last = s != self.num_permutation_sets - 1
            steps.append((STEP_PERMUTATION_EVAL, (s, has_last)))
        if self.lookups:
            steps.append((STEP_LOOKUP_EVAL, len(self.lookups)))
        if self.flavor == FLAVOR_HALO2:
            steps.append((STEP_X1, 1))
            steps.append((STEP_X2, 1))
            steps.append((STEP_F_COMMITMENT, 1))
            steps.append((STEP_X3, 1))
            steps.append((STEP_Q_EVALS, len(self.point_sets)))
            steps.append((STEP_X4, 1))
            steps.append((STEP_PI, 1))
        elif self.flavor == FLAVOR_GWC:
            steps.append((STEP_V, 1))
            steps.append((STEP_WITNESSES, len(self.rotation_order)))
            steps.append((STEP_U, 1))
        else:
            raise ValueError(f"unknown KZG flavor {self.flavor}")
        self.steps = steps

    # ------------------------------------------------------------------
    def vanishing_expressions(self):
        """The ordered expression list folded into hEval with Horner-in-y:
        gates, permutation boundary/continuity terms, permutation set products,
        5 lookup expressions per argument
        (code_emitters_plinth.rs:322-387, extraction/mod.rs:410-464)."""
        exprs = list(self.gates)

        n_sets = self.num_permutation_sets
        if n_sets:
            # l_0 * (1 - z_first(x))
            exprs.append(e_mul(("l0",), e_sub(e_const(1), ("perm_z", 0, "cur"))))
            # l_last * (z_last(x)^2 - z_last(x))
            zl = ("perm_z", n_sets - 1, "cur")
            exprs.append(e_mul(("l_last",), e_sub(e_mul(zl, zl), zl)))
            # (z_i(x) - z_{i-1}(omega^last x)) * l_0 for consecutive sets
            for s in range(1, n_sets):
                exprs.append(
                    e_mul(e_sub(("perm_z", s, "cur"), ("perm_z", s - 1, "last")), ("l0",))
                )
            # per-set: (z(omega x) * prod(v + beta*sigma + gamma)
            #           - z(x) * prod(v + beta*delta^k*X + gamma)) * l_active
            for s in range(n_sets):
                cols = self.permutation_columns[s * self.chunk_len : (s + 1) * self.chunk_len]
                left = ("perm_z", s, "next")
                right = ("perm_z", s, "cur")
                for j, (kind, col) in enumerate(cols):
                    perm_idx = s * self.chunk_len + j
                    v = self._column_eval_expr(kind, col)
                    left = e_mul(
                        left,
                        e_add(v, e_mul(e_var("beta"), ("perm_common", perm_idx)), e_var("gamma")),
                    )
                    right = e_mul(
                        right,
                        e_add(
                            v,
                            e_mul(
                                e_mul(e_var("beta"), ("identity",)),
                                e_pow(e_var("delta"), perm_idx),
                            ),
                            e_var("gamma"),
                        ),
                    )
                exprs.append(e_mul(e_sub(left, right), ("l_active",)))

        for i, (input_exprs, table_exprs) in enumerate(self.lookups):
            z_cur = ("lookup", i, "z_cur")
            z_next = ("lookup", i, "z_next")
            a_cur = ("lookup", i, "a_cur")
            a_prev = ("lookup", i, "a_prev")
            s_cur = ("lookup", i, "s_cur")
            a_comp = theta_fold(input_exprs)
            s_comp = theta_fold(table_exprs)
            # l1: l_0 * (1 - z)
            exprs.append(e_mul(("l0",), e_sub(e_const(1), z_cur)))
            # l2: l_last * (z^2 - z)
            exprs.append(e_mul(("l_last",), e_sub(e_mul(z_cur, z_cur), z_cur)))
            # l3: (z(wx)(a'+beta)(s'+gamma) - z(x)(A+beta)(S+gamma)) * active
            left = e_mul(z_next, e_add(a_cur, e_var("beta")), e_add(s_cur, e_var("gamma")))
            right = e_mul(z_cur, e_add(a_comp, e_var("beta")), e_add(s_comp, e_var("gamma")))
            exprs.append(e_mul(e_sub(left, right), ("l_active",)))
            # l4: l_0 * (a' - s')
            exprs.append(e_mul(("l0",), e_sub(a_cur, s_cur)))
            # l5: (a' - s')(a' - a'_prev) * active
            exprs.append(e_mul(e_sub(a_cur, s_cur), e_sub(a_cur, a_prev), ("l_active",)))
        return exprs

    def _column_eval_expr(self, kind: str, col: int):
        """Map a permutation column to its cur-rotation query eval expression
        (get_any_query_index analog, extraction/utils.rs:323-388)."""
        if kind == "advice":
            qi = self.advice_queries.index((col, ROT_CUR))
            return ("advice", qi)
        if kind == "fixed":
            qi = self.fixed_queries.index((col, ROT_CUR))
            return ("fixed", qi)
        if kind == "instance":
            # verifier: the directly computed instance_eval (instance poly at x);
            # prover: the instance column polynomial itself
            return ("instance_col", col)
        raise ValueError(kind)


def theta_fold(exprs):
    """Combine a lookup expression list: acc*theta + e
    (extraction/utils.rs:395-413)."""
    acc = exprs[0]
    for e in exprs[1:]:
        acc = e_add(e_mul(acc, e_var("theta")), e)
    return acc
