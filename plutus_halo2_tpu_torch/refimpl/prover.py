"""Native Halo2 prover (executable spec): the port's copy of
``plutus_halo2_tpu/refimpl/prover.py``.

The reference delegates proving to its halo2 fork (`create_proof`,
examples/simple_mul.rs:100-108); this framework implements proving natively so
circuits can be proven and verified end-to-end without external toolchains.
Produces proofs in exactly the byte layout the CircuitPlan's proof-extraction
steps describe, with challenges drawn from the Cardano-friendly transcript —
i.e. proofs the reference's generated on-chain verifiers would accept for the
same VK.

Supports both KZG multi-open flavors (Halo2-book and GWC19).

The same key, circuit, inputs and seed give the JAX package's proof bytes.
The polynomial runtime (``refimpl/poly.py``: the NTTs of interpolation and
of the coset transforms, the coset weighting, the scalings and the
quotient's division by Z_H) runs on the device ``prove`` is given: ``None``
is the card, ``"cpu"`` the kernels' plain versions. The expression
evaluation over the extended coset domain (``_VecEnv``, the quotient) and
the grand products stay host Python, as in the JAX package."""

from __future__ import annotations

import hashlib

from ..models.plan import (
    CircuitPlan,
    FLAVOR_GWC,
    FLAVOR_HALO2,
    eval_expr,
    rot_offset,
    theta_fold,
)
from ..models.verifier_torch import resolve_device
from .cs import Assignment
from .field import Q, FR_DELTA, FR_GENERATOR, fr_inv, fr_batch_inv
from .keygen import ProvingKey
from .multiopen import group_queries_by_rotation
from .poly import (
    coset_evaluate,
    coset_interpolate,
    domain_omega,
    lagrange_to_coeff,
    mul_array,
    poly_add,
    poly_divide_linear,
    poly_eval,
    poly_scale,
)
from .transcript import ProverTranscript


class _Rng:
    """Deterministic blinding source (the reference examples use a fixed-seed
    StdRng for the same purpose, examples/simple_mul.rs:76-77)."""

    def __init__(self, seed: bytes):
        self.seed = seed
        self.ctr = 0

    def scalar(self) -> int:
        h = hashlib.blake2b(self.seed + self.ctr.to_bytes(8, "little"), digest_size=64)
        self.ctr += 1
        return int.from_bytes(h.digest(), "little") % Q


class _VecEnv:
    """Row-vector expression environment over the extended coset domain.

    Scalars are ints; vectors are lists of length ext_n. The same expression
    list the verifier folds into hEval is evaluated here as polynomials."""

    def __init__(self, data):
        self.d = data

    # ring ops (mixed int/list)
    def add(self, a, b):
        if isinstance(a, list):
            if isinstance(b, list):
                return [(x + y) % Q for x, y in zip(a, b)]
            return [(x + b) % Q for x in a]
        if isinstance(b, list):
            return [(a + y) % Q for y in b]
        return (a + b) % Q

    def mul(self, a, b):
        if isinstance(a, list):
            if isinstance(b, list):
                return [x * y % Q for x, y in zip(a, b)]
            return [x * b % Q for x in a]
        if isinstance(b, list):
            return [a * y % Q for y in b]
        return a * b % Q

    def neg(self, a):
        if isinstance(a, list):
            return [(-x) % Q for x in a]
        return (-a) % Q

    def pow(self, a, k):
        if isinstance(a, list):
            return [pow(x, k, Q) for x in a]
        return pow(a, k, Q)

    def const(self, v):
        return v % Q

    def var(self, name):
        return self.d["vars"][name]

    def advice(self, qi):
        col, rot = self.d["advice_queries"][qi]
        return self.d["rotate"](self.d["advice_ext"][col], rot)

    def fixed(self, qi):
        col, rot = self.d["fixed_queries"][qi]
        return self.d["rotate"](self.d["fixed_ext"][col], rot)

    def instance(self, qi):
        col, rot = self.d["instance_queries"][qi]
        return self.d["rotate"](self.d["instance_ext"][col], rot)

    def instance_col(self, col):
        return self.d["instance_ext"][col]

    def perm_common(self, i):
        return self.d["sigma_ext"][i]

    def perm_z(self, s, which):
        vec = self.d["perm_z_ext"][s]
        return self.d["rotate"](vec, {"cur": "cur", "next": "next", "last": "last"}[which])

    def lookup(self, i, which):
        m = self.d["lookup_ext"][i]
        if which == "z_cur":
            return m["z"]
        if which == "z_next":
            return self.d["rotate"](m["z"], "next")
        if which == "a_cur":
            return m["a"]
        if which == "a_prev":
            return self.d["rotate"](m["a"], "prev")
        if which == "s_cur":
            return m["s"]
        raise ValueError(which)

    def identity(self):
        return self.d["identity_ext"]

    def l0(self):
        return self.d["l0_ext"]

    def l_last(self):
        return self.d["l_last_ext"]

    def l_active(self):
        return self.d["l_active_ext"]


class _RowEnv(_VecEnv):
    """Domain-row environment (size n, no coset) for lookup compression."""

    def advice(self, qi):
        col, rot = self.d["advice_queries"][qi]
        return self.d["rotate"](self.d["advice_vals"][col], rot)

    def fixed(self, qi):
        col, rot = self.d["fixed_queries"][qi]
        return self.d["rotate"](self.d["fixed_vals"][col], rot)

    def instance(self, qi):
        col, rot = self.d["instance_queries"][qi]
        return self.d["rotate"](self.d["instance_vals"][col], rot)


def _permute_expression_pair(a_vals, s_vals, usable, rng):
    """halo2 lookup permutation: sort inputs; align first occurrences with the
    table, fill the rest with leftover table entries (so S' is a permutation
    of S and A' of A on usable rows)."""
    a_sorted = sorted(a_vals[:usable])
    table_counts: dict = {}
    for v in s_vals[:usable]:
        table_counts[v] = table_counts.get(v, 0) + 1
    s_perm = [None] * usable
    for i, v in enumerate(a_sorted):
        if i == 0 or v != a_sorted[i - 1]:
            if table_counts.get(v, 0) == 0:
                raise ValueError(f"lookup input {v} not present in table")
            table_counts[v] -= 1
            s_perm[i] = v
    leftovers = iter(
        [v for v, c in table_counts.items() for _ in range(c)]
    )
    for i in range(usable):
        if s_perm[i] is None:
            s_perm[i] = next(leftovers)
    n = len(a_vals)
    a_out = a_sorted + [rng.scalar() for _ in range(n - usable)]
    s_out = s_perm + [rng.scalar() for _ in range(n - usable)]
    return a_out, s_out


def prove(pk: ProvingKey, plan: CircuitPlan, circuit, instance_values,
          seed: bytes = b"plutus-halo2-tpu-proof", allow_unsatisfied: bool = False, device=None) -> bytes:
    dev = resolve_device(device)
    spec = pk.spec
    n, k, bf = pk.n, pk.k, pk.blinding_factors
    usable = n - (bf + 1)
    omega, omega_inv = pk.omega, pk.omega_inv
    srs = pk.srs
    rng = _Rng(seed)

    if len(instance_values) != plan.vk.num_public_inputs:
        raise ValueError("instance count mismatch")

    t = ProverTranscript(plan.vk.transcript_repr)
    t.common_scalar(len(instance_values))
    for v in instance_values:
        t.common_scalar(v % Q)

    # -- advice assignment + blinding + commitments -------------------------
    asn = Assignment(spec)
    circuit.assign(asn)
    if asn.rows_used > usable:
        raise ValueError("circuit does not fit usable rows")
    advice_vals = asn.columns("advice", n)
    for col in advice_vals:
        for r in range(usable, n):
            col[r] = rng.scalar()
    advice_coeffs = [lagrange_to_coeff(v, omega, dev) for v in advice_vals]
    for c in advice_coeffs:
        t.write_point(srs.commit(c))

    fixed_vals = pk.fixed_values
    instance_vals = asn.columns("instance", n, instance_values)

    theta = t.squeeze_challenge()

    # -- lookups: compress + permute + commit permuted pairs ----------------
    def rotate_rows(vec, rot):
        off = rot_offset(rot, bf) % n
        return vec[off:] + vec[:off]

    row_env = _RowEnv(
        {
            "advice_queries": spec.advice_queries,
            "fixed_queries": spec.fixed_queries,
            "instance_queries": spec.instance_queries,
            "advice_vals": advice_vals,
            "fixed_vals": fixed_vals,
            "instance_vals": instance_vals,
            "rotate": rotate_rows,
            "vars": {"theta": theta},
        }
    )
    lookup_data = []
    for input_exprs, table_exprs in spec.lookups:
        a_comp = eval_expr(theta_fold(input_exprs), row_env)
        s_comp = eval_expr(theta_fold(table_exprs), row_env)
        if not isinstance(a_comp, list):
            a_comp = [a_comp] * n
        if not isinstance(s_comp, list):
            s_comp = [s_comp] * n
        a_perm, s_perm = _permute_expression_pair(a_comp, s_comp, usable, rng)
        a_coeffs = lagrange_to_coeff(a_perm, omega, dev)
        s_coeffs = lagrange_to_coeff(s_perm, omega, dev)
        t.write_point(srs.commit(a_coeffs))
        t.write_point(srs.commit(s_coeffs))
        lookup_data.append(
            {"A": a_comp, "S": s_comp, "a": a_perm, "s": s_perm,
             "a_coeffs": a_coeffs, "s_coeffs": s_coeffs}
        )

    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()

    # -- permutation grand products -----------------------------------------
    def column_values(kind, col):
        if kind == "advice":
            return advice_vals[col]
        if kind == "fixed":
            return fixed_vals[col]
        return instance_vals[col]

    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % Q

    perm_z_vals = []
    last_val = 1
    for s in range(plan.num_permutation_sets):
        cols = plan.permutation_columns[s * plan.chunk_len : (s + 1) * plan.chunk_len]
        num = [1] * usable  # identity side
        den = [1] * usable  # sigma side
        for j, (kind, col) in enumerate(cols):
            gidx = s * plan.chunk_len + j
            v = column_values(kind, col)
            sig = pk.sigma_values[gidx]
            dpow = pow(FR_DELTA, gidx, Q)
            for r in range(usable):
                num[r] = num[r] * ((v[r] + beta * dpow % Q * omega_pows[r] + gamma) % Q) % Q
                den[r] = den[r] * ((v[r] + beta * sig[r] + gamma) % Q) % Q
        den_inv = fr_batch_inv(den)
        z = [0] * n
        z[0] = last_val
        for r in range(usable):
            z[r + 1] = z[r] * num[r] % Q * den_inv[r] % Q
        last_val = z[usable]
        for r in range(usable + 1, n):
            z[r] = rng.scalar()
        perm_z_vals.append(z)
    perm_z_coeffs = [lagrange_to_coeff(z, omega, dev) for z in perm_z_vals]
    for c in perm_z_coeffs:
        t.write_point(srs.commit(c))

    # -- lookup grand products ----------------------------------------------
    for ld in lookup_data:
        A, S, a_p, s_p = ld["A"], ld["S"], ld["a"], ld["s"]
        den = [(a_p[r] + beta) * (s_p[r] + gamma) % Q for r in range(usable)]
        den_inv = fr_batch_inv(den)
        z = [0] * n
        z[0] = 1
        for r in range(usable):
            z[r + 1] = (
                z[r] * ((A[r] + beta) * (S[r] + gamma) % Q) % Q * den_inv[r] % Q
            )
        assert z[usable] == 1, "lookup grand product must telescope to 1"
        for r in range(usable + 1, n):
            z[r] = rng.scalar()
        ld["z"] = z
        ld["z_coeffs"] = lagrange_to_coeff(z, omega, dev)
        t.write_point(srs.commit(ld["z_coeffs"]))

    # -- vanishing random poly ----------------------------------------------
    random_coeffs = [rng.scalar() for _ in range(n)]
    t.write_point(srs.commit(random_coeffs))

    y = t.squeeze_challenge()

    # -- quotient h(X) on the extended coset domain -------------------------
    ext_factor = 1
    while ext_factor < plan.degree:
        ext_factor <<= 1
    ext_factor = max(ext_factor, 2)
    ext_k = k + ext_factor.bit_length() - 1
    ext_n = n * ext_factor
    ext_omega = domain_omega(ext_k)

    def to_ext(values):
        return coset_evaluate(lagrange_to_coeff(values, omega, dev), ext_n, ext_omega, device=dev)

    def rotate_ext(vec, rot):
        off = (rot_offset(rot, bf) * ext_factor) % ext_n
        return vec[off:] + vec[:off]

    l0_vals = [0] * n
    l0_vals[0] = 1
    l_last_vals = [0] * n
    l_last_vals[usable] = 1
    l_blind_vals = [0] * n
    for r in range(usable + 1, n):
        l_blind_vals[r] = 1

    identity_ext = [0] * ext_n
    acc = FR_GENERATOR
    for i in range(ext_n):
        identity_ext[i] = acc
        acc = acc * ext_omega % Q

    l0_ext = to_ext(l0_vals)
    l_last_ext = to_ext(l_last_vals)
    l_blind_ext = to_ext(l_blind_vals)
    l_active_ext = [(1 - l_last_ext[i] - l_blind_ext[i]) % Q for i in range(ext_n)]

    env = _VecEnv(
        {
            "advice_queries": spec.advice_queries,
            "fixed_queries": spec.fixed_queries,
            "instance_queries": spec.instance_queries,
            "advice_ext": [to_ext(v) for v in advice_vals],
            "fixed_ext": [to_ext(v) for v in fixed_vals],
            "instance_ext": [to_ext(v) for v in instance_vals],
            "sigma_ext": [to_ext(v) for v in pk.sigma_values],
            "perm_z_ext": [to_ext(z) for z in perm_z_vals],
            "lookup_ext": [
                {"z": to_ext(ld["z"]), "a": to_ext(ld["a"]), "s": to_ext(ld["s"])}
                for ld in lookup_data
            ],
            "identity_ext": identity_ext,
            "l0_ext": l0_ext,
            "l_last_ext": l_last_ext,
            "l_active_ext": l_active_ext,
            "rotate": rotate_ext,
            "vars": {
                "theta": theta,
                "beta": beta,
                "gamma": gamma,
                "delta": FR_DELTA,
                "instance_eval": None,  # not used on prover side
            },
        }
    )

    h_ext = [0] * ext_n
    for expr in plan.vanishing_expressions():
        vec = eval_expr(expr, env)
        if not isinstance(vec, list):
            vec = [vec] * ext_n
        h_ext = [(h * y + v) % Q for h, v in zip(h_ext, vec)]

    # divide by Z(X) = X^n - 1 pointwise on the coset
    cn = pow(FR_GENERATOR, n, Q)
    zh = [(cn * pow(ext_omega, (n * i) % ext_n, Q) - 1) % Q for i in range(ext_factor)]
    zh_inv = fr_batch_inv(zh)
    h_ext = mul_array(h_ext, zh_inv * (ext_n // ext_factor), dev)
    h_coeffs = coset_interpolate(h_ext, ext_omega, device=dev)
    n_splits = plan.num_vanishing_splits
    if not all(c == 0 for c in h_coeffs[n_splits * n :]):
        # a satisfied circuit always divides exactly; an unsatisfied one leaves
        # a nonzero remainder spilling past the quotient budget
        if not allow_unsatisfied:
            raise ValueError("circuit not satisfied: quotient division has remainder")
        h_coeffs = h_coeffs[: n_splits * n]
    h_chunks = [h_coeffs[i * n : (i + 1) * n] for i in range(n_splits)]
    for chunk in h_chunks:
        t.write_point(srs.commit(chunk))

    x = t.squeeze_challenge()
    xn = pow(x, n, Q)

    def rot_point(rot):
        off = rot_offset(rot, bf)
        if off >= 0:
            return x * pow(omega, off, Q) % Q
        return x * pow(omega_inv, -off, Q) % Q

    # -- evaluations in proof order -----------------------------------------
    for col, rot in spec.advice_queries:
        t.write_scalar(poly_eval(advice_coeffs[col], rot_point(rot)))
    for col, rot in spec.fixed_queries:
        t.write_scalar(poly_eval(pk.fixed_coeffs[col], rot_point(rot)))
    t.write_scalar(poly_eval(random_coeffs, x))
    for c in pk.sigma_coeffs:
        t.write_scalar(poly_eval(c, x))
    for s in range(plan.num_permutation_sets):
        t.write_scalar(poly_eval(perm_z_coeffs[s], x))
        t.write_scalar(poly_eval(perm_z_coeffs[s], rot_point("next")))
        if s != plan.num_permutation_sets - 1:
            t.write_scalar(poly_eval(perm_z_coeffs[s], rot_point("last")))
    for ld in lookup_data:
        t.write_scalar(poly_eval(ld["z_coeffs"], x))
        t.write_scalar(poly_eval(ld["z_coeffs"], rot_point("next")))
        t.write_scalar(poly_eval(ld["a_coeffs"], x))
        t.write_scalar(poly_eval(ld["a_coeffs"], rot_point("prev")))
        t.write_scalar(poly_eval(ld["s_coeffs"], x))

    # folded quotient polynomial backing the vanishing_g commitment
    h_folded = [0] * n
    xn_pow = 1
    for chunk in h_chunks:
        h_folded = poly_add(h_folded, poly_scale(chunk, xn_pow, dev))
        xn_pow = xn_pow * xn % Q

    def poly_for(com_ref):
        tag = com_ref[0]
        if tag == "advice_com":
            return advice_coeffs[com_ref[1]]
        if tag == "fixed_com":
            return pk.fixed_coeffs[com_ref[1]]
        if tag == "perm_z_com":
            return perm_z_coeffs[com_ref[1]]
        if tag == "perm_common_com":
            return pk.sigma_coeffs[com_ref[1]]
        if tag == "vanishing_g":
            return h_folded
        if tag == "vanishing_rand":
            return random_coeffs
        if tag == "lookup_z_com":
            return lookup_data[com_ref[1]]["z_coeffs"]
        if tag == "lookup_perm_input_com":
            return lookup_data[com_ref[1]]["a_coeffs"]
        if tag == "lookup_perm_table_com":
            return lookup_data[com_ref[1]]["s_coeffs"]
        raise ValueError(com_ref)

    # -- multiopen -----------------------------------------------------------
    if plan.flavor == FLAVOR_HALO2:
        x1 = t.squeeze_challenge()
        _x2 = t.squeeze_challenge()
        x2 = _x2

        q_polys, q_points = [], []
        for set_idx, rots in enumerate(plan.point_sets):
            members = [cd for cd in plan.commitment_data if cd[1] == set_idx]
            q = [0]
            x1_pow = 1
            for com, _si, _rots, _evals in members:
                q = poly_add(q, poly_scale(poly_for(com), x1_pow, dev))
                x1_pow = x1_pow * x1 % Q
            q_polys.append(q)
            q_points.append([rot_point(r) for r in rots])

        # f = sum_i x2^i (q_i - r_i) / prod (X - p)
        f = [0]
        x2_pow = 1
        for q, pts in zip(q_polys, q_points):
            evals = [poly_eval(q, p) for p in pts]
            # r_i: interpolation through (pts, evals) in coefficient form
            r = [0]
            for j, (pj, ej) in enumerate(zip(pts, evals)):
                basis = [1]
                denom = 1
                for m, pm in enumerate(pts):
                    if m == j:
                        continue
                    basis = poly_add([(-pm) % Q * c % Q for c in basis] , [0] + basis)
                    denom = denom * (pj - pm) % Q
                r = poly_add(r, poly_scale(basis, ej * fr_inv(denom) % Q, dev))
            num = poly_add(q, poly_scale(r, Q - 1, dev))
            for p in pts:
                num = poly_divide_linear(num + [0] if len(num) == 1 else num, p)
            f = poly_add(f, poly_scale(num, x2_pow, dev))
            x2_pow = x2_pow * x2 % Q
        t.write_point(srs.commit(f))

        x3 = t.squeeze_challenge()
        q_evals_x3 = [poly_eval(q, x3) for q in q_polys]
        for e in q_evals_x3:
            t.write_scalar(e)
        x4 = t.squeeze_challenge()

        F = [0]
        x4_pow = 1
        for q in q_polys + [f]:
            F = poly_add(F, poly_scale(q, x4_pow, dev))
            x4_pow = x4_pow * x4 % Q
        v = poly_eval(F, x3)
        pi_poly = poly_divide_linear(poly_add(F, [(-v) % Q]), x3)
        t.write_point(srs.commit(pi_poly))
    elif plan.flavor == FLAVOR_GWC:
        v_ch = t.squeeze_challenge()
        triples = [(q.rot, q.commitment, q.evaluation) for q in plan.all_queries_ordered()]
        grouped = group_queries_by_rotation(triples)
        for rot, members in grouped:
            z = rot_point(rot)
            w = [0]
            v_pow = 1
            for com, _ev in members:
                p = poly_for(com)
                pz = poly_eval(p, z)
                num = poly_add(p, [(-pz) % Q])
                w = poly_add(w, poly_scale(poly_divide_linear(num, z), v_pow, dev))
                v_pow = v_pow * v_ch % Q
            t.write_point(srs.commit(w))
        _u = t.squeeze_challenge()
    else:
        raise ValueError(plan.flavor)

    return t.finalize()
