"""Plan-driven Halo2 verifier (executable spec).

Interprets a CircuitPlan against a proof byte string — the same computation
the reference's generated Plinth/Aiken verifiers perform
(plinth-verifier/templates/verification_halo2_kzg.hbs:113-222 and
verification_gwc19_kzg.hbs), with the same step order, challenge derivation,
vanishing fold, and multi-open accumulation: the port's copy of
``plutus_halo2_tpu/refimpl/verifier.py``, the oracle the batched verifier
(``models/verifier_torch.py``) is held against; ``utils/tracing.py`` formats
and diffs its traces."""

from __future__ import annotations

from ..models.plan import (
    CircuitPlan,
    FLAVOR_GWC,
    FLAVOR_HALO2,
    eval_expr,
    rot_offset,
)
from .field import Q, FR_DELTA, fr_inv
from .lagrange import lagrange_polynomial_basis, powers, rotated_omegas
from .multiopen import build_msm_gwc, build_msm_halo2, eval_msm
from .pairing import final_verify, miller_loop
from .curve import G1_GEN
from .transcript import Transcript


class _ScalarEnv:
    def __init__(self, vars_, advice_evals, fixed_evals, instance_evals,
                 perm_common_evals, perm_z_evals, lookup_evals):
        self.vars = vars_
        self.advice_evals = advice_evals
        self.fixed_evals = fixed_evals
        self.instance_evals = instance_evals
        self.perm_common_evals = perm_common_evals
        self.perm_z_evals = perm_z_evals
        self.lookup_evals = lookup_evals

    def add(self, a, b):
        return (a + b) % Q

    def mul(self, a, b):
        return a * b % Q

    def neg(self, a):
        return (-a) % Q

    def pow(self, a, k):
        return pow(a, k, Q)

    def const(self, v):
        return v % Q

    def var(self, name):
        return self.vars[name]

    def advice(self, qi):
        return self.advice_evals[qi]

    def fixed(self, qi):
        return self.fixed_evals[qi]

    def instance(self, qi):
        return self.instance_evals[qi]

    def instance_col(self, col):
        return self.vars["instance_eval"]

    def perm_common(self, i):
        return self.perm_common_evals[i]

    def perm_z(self, s, which):
        return self.perm_z_evals[s][which]

    def lookup(self, i, which):
        return self.lookup_evals[i][which]

    def identity(self):
        return self.vars["x"]

    def l0(self):
        return self.vars["evaluation_at_0"]

    def l_last(self):
        return self.vars["last_evaluation"]

    def l_active(self):
        return self.vars["active_rows"]


def verify(plan: CircuitPlan, proof: bytes, public_inputs, collect_traces: bool = False):
    """Returns (accepted: bool, traces: dict). Decompression/parse failures
    reject (the on-chain builtins would abort the script)."""
    traces: dict = {}
    try:
        ok = _verify_inner(plan, proof, public_inputs, traces, collect_traces)
    except (ValueError, ZeroDivisionError) as e:
        traces["parse_error"] = str(e)
        return False, traces
    return ok, traces


def _verify_inner(plan, proof, public_inputs, traces, collect_traces):
    vk = plan.vk
    if len(public_inputs) != vk.num_public_inputs:
        raise ValueError("public input count mismatch")

    t = Transcript(proof, vk.transcript_repr)
    t.common_scalar(len(public_inputs))
    public_inputs = [v % Q for v in public_inputs]
    for v in public_inputs:
        t.common_scalar(v)

    # ---- proof walk (PES) -------------------------------------------------
    st: dict = {
        "advice_coms": [],
        "lookup_permuted": [],
        "perm_coms": [],
        "lookup_z_coms": [],
        "splits": [],
        "perm_z_evals": [],
        "lookup_evals": [],
        "q_evals": [],
        "witnesses": [],
    }
    for tag, payload in plan.steps:
        if tag == "advice_commitments":
            st["advice_coms"] = [t.read_point() for _ in range(payload)]
        elif tag == "theta":
            st["theta"] = t.squeeze_challenge()
        elif tag == "lookup_permuted":
            st["lookup_permuted"] = [(t.read_point(), t.read_point()) for _ in range(payload)]
        elif tag == "beta":
            st["beta"] = t.squeeze_challenge()
        elif tag == "gamma":
            st["gamma"] = t.squeeze_challenge()
        elif tag == "permutation_committed":
            st["perm_coms"] = [t.read_point() for _ in range(payload)]
        elif tag == "lookup_commitment":
            st["lookup_z_coms"] = [t.read_point() for _ in range(payload)]
        elif tag == "vanishing_rand":
            st["vanishing_rand"] = t.read_point()
        elif tag == "y":
            st["y"] = t.squeeze_challenge()
        elif tag == "vanishing_split":
            st["splits"] = [t.read_point() for _ in range(payload)]
        elif tag == "x":
            st["x"] = t.squeeze_challenge()
        elif tag == "advice_eval":
            st["advice_evals"] = [t.read_scalar() for _ in range(payload)]
        elif tag == "fixed_eval":
            st["fixed_evals"] = [t.read_scalar() for _ in range(payload)]
        elif tag == "random_eval":
            st["random_eval"] = t.read_scalar()
        elif tag == "permutation_common":
            st["perm_common_evals"] = [t.read_scalar() for _ in range(payload)]
        elif tag == "permutation_eval":
            _s, has_last = payload
            evals = {"cur": t.read_scalar(), "next": t.read_scalar()}
            if has_last:
                evals["last"] = t.read_scalar()
            st["perm_z_evals"].append(evals)
        elif tag == "lookup_eval":
            for _ in range(payload):
                st["lookup_evals"].append(
                    {
                        "z_cur": t.read_scalar(),
                        "z_next": t.read_scalar(),
                        "a_cur": t.read_scalar(),
                        "a_prev": t.read_scalar(),
                        "s_cur": t.read_scalar(),
                    }
                )
        elif tag == "x1":
            st["x1"] = t.squeeze_challenge()
        elif tag == "x2":
            st["x2"] = t.squeeze_challenge()
        elif tag == "f_commitment":
            st["f_commitment"] = t.read_point()
        elif tag == "x3":
            st["x3"] = t.squeeze_challenge()
        elif tag == "q_evals":
            st["q_evals"] = [t.read_scalar() for _ in range(payload)]
        elif tag == "x4":
            st["x4"] = t.squeeze_challenge()
        elif tag == "pi":
            st["pi"] = t.read_point()
        elif tag == "v":
            st["v"] = t.squeeze_challenge()
        elif tag == "witnesses":
            st["witnesses"] = [t.read_point() for _ in range(payload)]
        elif tag == "u":
            st["u"] = t.squeeze_challenge()
        else:
            raise ValueError(f"unknown step {tag}")

    # ---- scalar-side computation (hbs:121-179) ----------------------------
    x = st["x"]
    n = vk.n
    bf = vk.blinding_factors
    xn = pow(x, n, Q)

    def rot_point(rot):
        off = rot_offset(rot, bf)
        base = vk.omega if off >= 0 else vk.omega_inv
        return x * pow(base, abs(off), Q) % Q

    # instance evaluation from public inputs
    if public_inputs:
        rot_insts = rotated_omegas(vk.omega, vk.omega_inv, 0, len(public_inputs))
        basis_inst = lagrange_polynomial_basis(x, xn, vk.barycentric_weight, rot_insts)
        instance_eval = 0
        for b, v in zip(basis_inst, public_inputs):
            instance_eval = (instance_eval + b * v) % Q
    else:
        instance_eval = 0

    # vanishing-region lagrange evals: rotations -(bf+1) .. 0
    rot_van = rotated_omegas(vk.omega, vk.omega_inv, -(bf + 1), 0)
    basis_van = lagrange_polynomial_basis(x, xn, vk.barycentric_weight, rot_van)
    last_evaluation = basis_van[0]
    sum_blind = sum(basis_van[1 : 1 + bf]) % Q
    evaluation_at_0 = basis_van[1 + bf]
    active_rows = (1 - (last_evaluation + sum_blind)) % Q

    env = _ScalarEnv(
        vars_={
            "theta": st.get("theta", 0),
            "beta": st.get("beta", 0),
            "gamma": st.get("gamma", 0),
            "delta": FR_DELTA,
            "x": x,
            "instance_eval": instance_eval,
            "evaluation_at_0": evaluation_at_0,
            "last_evaluation": last_evaluation,
            "active_rows": active_rows,
        },
        advice_evals=st.get("advice_evals", []),
        fixed_evals=st.get("fixed_evals", []),
        instance_evals=[],
        perm_common_evals=st.get("perm_common_evals", []),
        perm_z_evals=st["perm_z_evals"],
        lookup_evals=st["lookup_evals"],
    )

    h_eval = 0
    for expr in plan.vanishing_expressions():
        h_eval = (h_eval * st["y"] + eval_expr(expr, env)) % Q
    vanishing_s = h_eval * fr_inv((xn - 1) % Q) % Q

    # vanishing_g: Horner in xn over reversed splits (extraction/mod.rs:637-686)
    from .curve import g1_add, g1_mul

    vanishing_g = None
    for split in reversed(st["splits"]):
        scaled = g1_mul(vanishing_g, xn) if vanishing_g is not None else None
        vanishing_g = g1_add(scaled, split)

    if collect_traces:
        traces.update(
            {
                "x": x,
                "y": st["y"],
                "hEval": h_eval,
                "vanishing_s": vanishing_s,
                "instance_eval": instance_eval,
            }
        )

    # ---- resolve commitment / evaluation references -----------------------
    def com_value(ref):
        tag = ref[0]
        if tag == "advice_com":
            return st["advice_coms"][ref[1]]
        if tag == "fixed_com":
            return vk.fixed_commitments[ref[1]]
        if tag == "perm_z_com":
            return st["perm_coms"][ref[1]]
        if tag == "perm_common_com":
            return vk.permutation_commitments[ref[1]]
        if tag == "vanishing_g":
            return vanishing_g
        if tag == "vanishing_rand":
            return st["vanishing_rand"]
        if tag == "lookup_z_com":
            return st["lookup_z_coms"][ref[1]]
        if tag == "lookup_perm_input_com":
            return st["lookup_permuted"][ref[1]][0]
        if tag == "lookup_perm_table_com":
            return st["lookup_permuted"][ref[1]][1]
        raise ValueError(ref)

    def eval_value(ref):
        tag = ref[0]
        if tag == "advice_eval":
            return st["advice_evals"][ref[1]]
        if tag == "fixed_eval":
            return st["fixed_evals"][ref[1]]
        if tag == "perm_z":
            return st["perm_z_evals"][ref[1]][ref[2]]
        if tag == "perm_common":
            return st["perm_common_evals"][ref[1]]
        if tag == "vanishing_s":
            return vanishing_s
        if tag == "random_eval":
            return st["random_eval"]
        if tag == "lookup":
            return st["lookup_evals"][ref[1]][ref[2]]
        raise ValueError(ref)

    # ---- multiopen accumulation + pairing ---------------------------------
    if plan.flavor == FLAVOR_HALO2:
        commitment_map = [
            (com_value(com), set_idx, [rot_point(r) for r in rots], [eval_value(e) for e in evals])
            for com, set_idx, rots, evals in plan.commitment_data
        ]
        point_sets = [[rot_point(r) for r in rots] for rots in plan.point_sets]
        x1_powers = powers(plan.x1_powers_count, st["x1"])
        x4_powers = powers(plan.x4_powers_count, st["x4"])
        msm = build_msm_halo2(
            x1_powers, st["x2"], st["x3"], x4_powers,
            st["f_commitment"], st["pi"], st["q_evals"], commitment_map, point_sets,
        )
        el = st["pi"]
        er = eval_msm(msm)
    elif plan.flavor == FLAVOR_GWC:
        triples = [
            (q.rot, com_value(q.commitment), eval_value(q.evaluation))
            for q in plan.all_queries_ordered()
        ]
        rotation_values = [rot_point(r) for r in plan.rotation_order]
        left, right = build_msm_gwc(st["v"], st["u"], triples, st["witnesses"], rotation_values)
        el = eval_msm(left)
        er = eval_msm(right)
    else:
        raise ValueError(plan.flavor)

    if collect_traces:
        traces["el"] = el
        traces["er"] = er

    ml_l = miller_loop(el, vk.s_g2)
    from .curve import G2_GEN

    ml_r = miller_loop(er, G2_GEN)
    return final_verify(ml_l, ml_r)
