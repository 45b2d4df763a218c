"""KZG multi-open accumulation, both flavors (executable spec): the benchmark's
frozen copy of ``plutus_halo2_tpu_torch/refimpl/multiopen.py``.

Halo2-book flavor mirrors Halo2MultiOpenMSM.hs:59-189 (buildQ, f_eval via
per-set lagrange interpolation, v, final commitment MSM, final pairing terms).
GWC19 flavor mirrors the compile-time construction of GwcMultiOpenMSM.hs:96-239
and code_emitters_aiken.rs:795-867: queries grouped by rotation in
first-occurrence order, u-weighted across groups, v-weighted within.

MSMs are kept as (scalar, point) term lists — the spec analog of MSMTypes.hs —
and evaluated by the caller. A commitment may itself be such a list (``scaled_terms``).
"""

from __future__ import annotations

from .field import Q, fr_inv
from .curve import G1_GEN, g1_msm, g1_neg
from .lagrange import lagrange_evaluation


def scaled_terms(coef: int, com) -> list:
    """coef * com as (scalar, point) terms: com is a point, or a list of
    terms standing for their sum (the vanishing argument's
    sum_j xn^j split_j)."""
    if isinstance(com, list):
        return [(coef * s % Q, p) for s, p in com]
    return [(coef % Q, com)]


# ---------------------------------------------------------------------------
# Halo2-book flavor
# ---------------------------------------------------------------------------

def build_q(commitment_map, n_point_sets: int, x1_powers):
    """Per point-set: x1-weighted commitment MSM and x1-weighted eval vectors.

    commitment_map entries: (point, set_index, points, evals) exactly as the
    generated `commitment_data` literal (code_emitters_plinth.rs:484-502).
    Returns (q_coms: list[MSM], q_eval_sets: list[list[int]])."""
    q_coms, q_eval_sets = [], []
    for set_idx in range(n_point_sets):
        members = [cd for cd in commitment_map if cd[1] == set_idx]
        msm = [term for i, cd in enumerate(members) for term in scaled_terms(x1_powers[i], cd[0])]
        evals: list[int] = []
        for i, cd in enumerate(members):
            scaled = [e * x1_powers[i] % Q for e in cd[3]]
            if not evals:
                evals = scaled
            else:
                evals = [(a + b) % Q for a, b in zip(evals, scaled)]
        q_coms.append(msm)
        q_eval_sets.append(evals)
    return q_coms, q_eval_sets


def evaluate_lagrange_polynomials(point_sets, q_eval_sets, x2, x3, proof_q_evals):
    """f_eval = Horner-in-x2 over sets of (q_eval - r(x3)) / prod(x3 - pt)
    — Halo2MultiOpenMSM.hs:124-145 (note the reversed fold order)."""
    acc = 0
    items = list(zip(zip(point_sets, q_eval_sets), proof_q_evals))
    for (points, evals), proof_q_eval in reversed(items):
        r_eval = lagrange_evaluation(list(zip(points, evals)), x3)
        den = 1
        for pt in points:
            den = den * (x3 - pt) % Q
        term = (proof_q_eval - r_eval) * fr_inv(den) % Q
        acc = (acc * x2 + term) % Q
    return acc


def compute_v(f_eval, x4_powers, proof_q_evals):
    """v = sum x4^i * (q_evals ++ [f_eval])_i — Halo2MultiOpenMSM.hs:99-109."""
    acc = 0
    for p, e in zip(x4_powers, list(proof_q_evals) + [f_eval]):
        acc = (acc + p * e) % Q
    return acc


def final_commitment_msm(q_coms, f_comm, x4_powers):
    """sum x4^i * q_com_i + x4^n * f_comm as one MSM — :111-122."""
    msm = []
    for p, q_msm in zip(x4_powers, q_coms + [[(1, f_comm)]]):
        msm.extend([(p * s % Q, pt) for s, pt in q_msm])
    return msm


def build_msm_halo2(x1_powers, x2, x3, x4_powers, f_comm, pi_commitment,
                    proof_q_evals, commitment_map, point_sets):
    """The pairing RHS MSM (Halo2MultiOpenMSM.hs:59-97). Pairing check:
    e(pi, s_g2) == e(eval(msm), g2)."""
    q_coms, q_eval_sets = build_q(commitment_map, len(point_sets), x1_powers)
    f_eval = evaluate_lagrange_polynomials(point_sets, q_eval_sets, x2, x3, proof_q_evals)
    msm = final_commitment_msm(q_coms, f_comm, x4_powers)
    v = compute_v(f_eval, x4_powers, proof_q_evals)
    msm.append((v, g1_neg(G1_GEN)))
    msm.append((x3, pi_commitment))
    return msm


# ---------------------------------------------------------------------------
# GWC19 flavor
# ---------------------------------------------------------------------------

def group_queries_by_rotation(queries):
    """Group (rotation_key, commitment, eval) triples by rotation in
    first-occurrence order (GwcMultiOpenMSM.hs squashQueries:69-86,
    code_emitters_aiken.rs:764-782)."""
    order: list = []
    groups: dict = {}
    for rot, comm, ev in queries:
        if rot not in groups:
            groups[rot] = []
            order.append(rot)
        groups[rot].append((comm, ev))
    return [(rot, groups[rot]) for rot in order]


def build_msm_gwc(v, u, queries, witnesses, rotation_values):
    """GWC19 pairing preparation. queries: (rotation_key, commitment, eval)
    in canonical order; witnesses: w_i per rotation group (proof points);
    rotation_values: the scalar z_i = rotated x per group, in group order.

    Returns (left_msm, right_msm): left = sum u^i w_i;
    right = sum u^i z_i w_i + sum_i u^i sum_j v^j c_ij - (sum u^i sum v^j e_ij) G1
    (GwcMultiOpenMSM.hs:96-135)."""
    grouped = group_queries_by_rotation(queries)
    assert len(grouped) == len(witnesses) == len(rotation_values)
    u_pow = 1
    left, right = [], []
    final_eval = 0
    for (rot, members), w, z in zip(grouped, witnesses, rotation_values):
        left.append((u_pow, w))
        right.append((u_pow * z % Q, w))
        v_pow = 1
        inner_eval = 0
        for comm, ev in members:
            right.extend(scaled_terms(v_pow * u_pow, comm))
            inner_eval = (inner_eval + v_pow * ev) % Q
            v_pow = v_pow * v % Q
        final_eval = (final_eval + u_pow * inner_eval) % Q
        u_pow = u_pow * u % Q
    right.append((final_eval, g1_neg(G1_GEN)))
    return left, right


def eval_msm(msm):
    """Naive MSM fold — semantics of MSMEval.hs:18-27."""
    return g1_msm([s for s, _ in msm], [p for _, p in msm])
