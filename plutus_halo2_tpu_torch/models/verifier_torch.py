"""Plan-specialized batched Halo2 verifier in PyTorch: the port of
``plutus_halo2_tpu/models/verifier_jax.py::JaxVerifier``.

Pipeline per batch (each proof a row):
  proof bytes -> transcript buffer (gather) -> all Fiat-Shamir challenges
  (transcript kernel) -> point decompression (with y-hints the hinted
  decompression kernel, which in the default "aggregate" subgroup mode also
  runs the per-row aggregate subgroup test; without, the Fp pow kernel as
  the sqrt ladder, then the subgroup kernel) -> scalar work over Fr (one
  pooled batch inversion rooted in the Fr pow kernel, Lagrange basis,
  vanishing fold) -> the multi-open MSM (MSM kernel) -> the pairing check
  (pairing kernel).

Both KZG multi-open flavors of the reference are ported: the Halo2-book
accumulation (one MSM, ``_multiopen_halo2``) and GWC19 (``_multiopen_gwc``:
the left and right pairing sides as two MSM calls, each de-duplicated on
its own, as ``JaxVerifier``'s ``run_msm_pair`` runs them).

``verify_rlc`` shares that core and replaces the per-row pairing by one
pairing per group of rows on random-linear-combination aggregates (the MSM
kernel at K = group), re-checking the rows of failing groups exactly.

On a CUDA device the stages named above run as the hand-written kernels of
``csrc/``; the O(1)-per-proof glue between them is batched torch code
(``ops/limb.py``). On the CPU every stage runs its plain version.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..ops import cuda_blake, cuda_curve, cuda_field, cuda_pairing
from ..ops import curve as tc
from ..ops.curve import DEFAULT_SUBGROUP_ROUNDS
from ..ops.limb import FP_SPEC, FR_SPEC, fr
from ..ops.pairing import prepare_g2
from ..refimpl.curve import G1_GEN, G2_GEN, g1_neg
from ..refimpl.field import FR_DELTA, P, Q
from ..refimpl.multiopen import group_queries_by_rotation
from .layout import build_layout
from .plan import FLAVOR_HALO2, CircuitPlan, eval_expr, rot_offset

_R256 = pow(2, 256, Q)

# host constants, as JaxVerifier holds them (see from_jax_state)
STATE_KEYS = (
    "fixed_coms", "perm_coms", "prep_sg2", "prep_g2", "rot_mult",
    "van_rotations", "inst_rotations", "bary_mont", "r256_mont", "one_fr",
)

# commitment reference tag -> static MSM point key ('#' = VK constant)
_COM_KEYS = {
    "advice_com": "advice_{}",
    "fixed_com": "#fixed_{}",
    "perm_z_com": "perm_z_{}",
    "perm_common_com": "#perm_{}",
    "vanishing_rand": "vanishing_rand",
    "lookup_z_com": "lookup_z_{}",
    "lookup_perm_input_com": "lookup_perm_input_{}",
    "lookup_perm_table_com": "lookup_perm_table_{}",
}

def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device


class _FrEnv:
    """Scalar-expression environment over Montgomery Fr limb tensors."""

    def __init__(self, device, vars_, advice_evals, fixed_evals, perm_common_evals,
                 perm_z_evals, lookup_evals):
        self.device = device
        self.vars = vars_
        self.advice_evals = advice_evals
        self.fixed_evals = fixed_evals
        self.perm_common_evals = perm_common_evals
        self.perm_z_evals = perm_z_evals
        self.lookup_evals = lookup_evals

    def add(self, a, b):
        return fr.add(a, b)

    def mul(self, a, b):
        return fr.mul(a, b)

    def neg(self, a):
        return fr.neg(a)

    def pow(self, a, k):
        # static small exponents in gate expressions: repeated squaring
        if k == 0:
            return fr.one(a.shape[:-1], self.device)
        result, base = None, a
        while k:
            if k & 1:
                result = base if result is None else fr.mul(result, base)
            k >>= 1
            if k:
                base = fr.sqr(base)
        return result

    def const(self, v):
        return fr.const(v, self.device)

    def var(self, name):
        return self.vars[name]

    def advice(self, qi):
        return self.advice_evals[qi]

    def fixed(self, qi):
        return self.fixed_evals[qi]

    def instance(self, qi):
        raise NotImplementedError("instance queries in gates are not supported")

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


def _precompute_delta_pows(expr):
    """Host-side: fold ('pow', ('var','delta'), k) into constants."""
    if not isinstance(expr, tuple):
        return expr
    if expr[0] == "pow" and expr[1] == ("var", "delta"):
        return ("const", pow(FR_DELTA, expr[2], Q))
    return tuple(_precompute_delta_pows(e) if isinstance(e, tuple) else e for e in expr)


def dedup_terms(terms):
    """Merge MSM terms on the same point by summing their scalars, in
    insertion order (the reference's flatten_msm / optimize_msm,
    code_emitters_aiken.rs:913-1016): [(point_key, coeff)] -> the same."""
    order, acc = [], {}
    for key, c in terms:
        if key in acc:
            acc[key] = fr.add(acc[key], c)
        else:
            acc[key] = c
            order.append(key)
    return [(k, acc[k]) for k in order]


def host_state(plan: CircuitPlan) -> dict:
    """The verifier's host constants computed from the plan's VK, as numpy
    int64 limb arrays (the same values JaxVerifier.__init__ computes)."""
    vk = plan.vk
    n_pi = vk.num_public_inputs
    L = FP_SPEC.L
    st = {
        "fixed_coms": np.stack([tc.host_point_to_mont(p) for p in vk.fixed_commitments])
        if vk.fixed_commitments else np.zeros((0, 3, L), np.int64),
        "perm_coms": np.stack([tc.host_point_to_mont(p) for p in vk.permutation_commitments])
        if vk.permutation_commitments else np.zeros((0, 3, L), np.int64),
        "prep_sg2": prepare_g2(vk.s_g2),
        "prep_g2": prepare_g2(G2_GEN),
    }
    rot_mult = {}
    for r in ["cur", "next", "prev", "last"]:
        off = rot_offset(r, vk.blinding_factors)
        base = vk.omega if off >= 0 else vk.omega_inv
        rot_mult[off] = FR_SPEC.to_mont(pow(base, abs(off), Q))
    st["rot_mult"] = rot_mult
    bf = vk.blinding_factors
    # vanishing-region rotations: -(bf+1) .. 0 (hbs:142-151)
    st["van_rotations"] = np.stack(
        [FR_SPEC.to_mont(pow(vk.omega_inv, k, Q)) for k in range(bf + 1, 0, -1)]
        + [FR_SPEC.to_mont(1)]
    )
    st["inst_rotations"] = np.stack(
        [FR_SPEC.to_mont(pow(vk.omega, i, Q)) for i in range(max(n_pi, 1))]
    )
    st["bary_mont"] = FR_SPEC.to_mont(vk.barycentric_weight)
    st["r256_mont"] = FR_SPEC.to_mont(_R256)
    st["one_fr"] = FR_SPEC.to_mont(1)
    return st


class TorchVerifier:
    """verify(proof_bytes (B, PLEN) uint8, public_inputs (B, n_pi, 17)
    canonical Fr limbs) -> (B,) bool. Build once per plan.

    device: None resolves to "cuda" (raises without a GPU); "cpu" runs the
    plain versions of every kernel.

    subgroup_check: the reference rejects proof points outside the q-order
    subgroup inside bls12_381_G1_uncompress. Modes, as JaxVerifier's:
      "aggregate" (default): per row, the points summed with fresh
          verifier-side weights and only the aggregate tested; honest rows
          always pass, a non-subgroup encoding evades with probability
          <= 3^-subgroup_rounds per submission;
      "exact" / True: the per-point test (plain torch on the device);
      "off" / False: encodings are trusted to be subgroup members.
    The proof verdict itself is cofactor-insensitive either way."""

    def __init__(self, plan: CircuitPlan, device=None,
                 subgroup_check: bool | str = "aggregate",
                 subgroup_rounds: int = DEFAULT_SUBGROUP_ROUNDS, _state: dict | None = None):
        self.device = resolve_device(device)
        if subgroup_check is True:
            subgroup_check = "exact"
        if subgroup_check is False:
            subgroup_check = "off"
        if subgroup_check not in ("aggregate", "exact", "off"):
            raise ValueError(f"unknown subgroup_check {subgroup_check!r}")
        if int(subgroup_rounds) < 1:
            raise ValueError(f"subgroup_rounds must be >= 1, got {subgroup_rounds}")
        self.subgroup_check = subgroup_check
        self.subgroup_rounds = int(subgroup_rounds)
        self.plan = plan
        self.layout = build_layout(plan)
        self.n_pi = plan.vk.num_public_inputs
        st = host_state(plan) if _state is None else _state
        self.state = st
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

        self.fixed_coms = t(st["fixed_coms"])
        self.perm_coms = t(st["perm_coms"])
        self.rot_mult = {int(k): t(v) for k, v in st["rot_mult"].items()}
        self.van_rotations = t(st["van_rotations"])
        self.inst_rotations = t(st["inst_rotations"])
        self.bary_mont = t(st["bary_mont"])
        self.r256_mont = t(st["r256_mont"])
        self.one_fr = t(st["one_fr"])
        self.pair = cuda_pairing.PreparedPair(st["prep_sg2"], st["prep_g2"])
        self.neg_g1 = t(tc.host_point_to_mont(g1_neg(G1_GEN)))
        self.ident = t(tc.host_point_to_mont(None))
        self.exprs = [_precompute_delta_pows(e) for e in plan.vanishing_expressions()]

        lay = self.layout
        src = np.zeros(lay.total_len, np.int64)
        from_proof = np.zeros(lay.total_len, bool)
        for k, pos in enumerate(lay.proof_scatter):
            src[pos] = k
            from_proof[pos] = True
        self._buf_src = t(src)
        self._buf_from_proof = torch.as_tensor(from_proof, device=dev)
        self._template = torch.as_tensor(lay.template, device=dev)
        self._sq_lengths = [mlen for _name, mlen in lay.squeezes]
        self._sc_idx = t(np.stack([np.arange(32) + off for off in lay.scalar_offsets.values()])) \
            if lay.scalar_offsets else None
        self._pt_idx = t(np.stack([np.arange(48) + off for off in lay.point_offsets.values()]))
        self.msm_term_counts: list[int] = []  # K of each MSM of the last call
        # the multi-open MSMs' function, (B, K, 3, L) points and (B, K, 17)
        # scalars -> (B, 3, L): parallel.mesh.verify_2d sets it to the
        # point-sharded MSM over a group's mp axis for the call and restores
        # it; the RLC aggregation stays whole
        self.msm = cuda_curve.msm
        self.timings: dict | None = None  # set to {} to record per-stage CUDA events

    @classmethod
    def from_jax_state(cls, plan: CircuitPlan, state: dict, device=None,
                       subgroup_check: bool | str = "aggregate",
                       subgroup_rounds: int = DEFAULT_SUBGROUP_ROUNDS) -> "TorchVerifier":
        """A verifier that computes with exactly the given host constants
        (the JAX verifier's attributes named in STATE_KEYS, as numpy arrays
        or dicts of them) instead of deriving its own."""
        missing = [k for k in STATE_KEYS if k not in state]
        if missing:
            raise ValueError(f"state lacks {missing}")
        st = {k: state[k] for k in STATE_KEYS}
        st["prep_sg2"] = {k: np.asarray(v).astype(np.int64) for k, v in st["prep_sg2"].items()}
        st["prep_g2"] = {k: np.asarray(v).astype(np.int64) for k, v in st["prep_g2"].items()}
        return cls(plan, device=device, subgroup_check=subgroup_check,
                   subgroup_rounds=subgroup_rounds, _state=st)

    # ------------------------------------------------------------------
    def encode_public_inputs(self, pis) -> np.ndarray:
        """Host: (B, n_pi) ints -> (B, n_pi, L) canonical Fr limbs."""
        if not len(pis):
            return np.zeros((0, self.n_pi, FR_SPEC.L), np.int64)
        return np.stack([np.stack([FR_SPEC.encode(v % Q) for v in row]) for row in pis])

    def subgroup_weights(self, generator: torch.Generator | None = None):
        """Fresh per-batch aggregation weights for the "aggregate" mode
        ((rounds, n_points) int64 on the CPU), or None in other modes."""
        if self.subgroup_check != "aggregate":
            return None
        return tc.subgroup_weights(len(self.layout.point_offsets), self.subgroup_rounds, generator)

    def compute_y_hints(self, proof_bytes) -> np.ndarray:
        """Host: (B, PLEN) uint8 proofs -> (B, n_points, L) int64 canonical
        Fp limbs holding a candidate sqrt(x^3 + 4) per compressed proof
        point. Pure acceleration data: decompression re-checks every hint,
        and a wrong one can only reject its row. Duplicate proof rows are
        computed once."""
        proof_bytes = np.ascontiguousarray(np.asarray(proof_bytes), dtype=np.uint8)
        offs = list(self.layout.point_offsets.values())
        uniq, inv = np.unique(proof_bytes, axis=0, return_inverse=True)
        e = (P + 1) >> 2
        cache = np.zeros((uniq.shape[0], len(offs), FP_SPEC.L), np.int64)
        for u in range(uniq.shape[0]):
            row = uniq[u].tobytes()
            for i, off in enumerate(offs):
                x = int.from_bytes(bytes([row[off] & 0x1F]) + row[off + 1 : off + 48], "big") % P
                rhs = (x * x % P * x + 4) % P
                cache[u, i] = FP_SPEC.encode(pow(rhs, e, P))
        return cache[inv.reshape(-1)]

    def verify(self, proof_bytes, public_inputs, y_hints=None,
               generator: torch.Generator | None = None, sub_weights=None):
        """proof_bytes (B, PLEN) uint8, public_inputs (B, n_pi, 17) canonical
        Fr limbs (numpy or tensors) -> (B,) bool tensor on the device.

        y_hints: optional (B, n_points, 25) UNTRUSTED candidate y-coordinates
        (compute_y_hints): decompression checks y^2 == x^3 + 4 and the sign
        instead of running the sqrt ladder; a wrong hint can only reject.
        generator: randomness of the aggregate subgroup test's fresh weights
        (the OS's randomness when omitted). sub_weights: those weights drawn
        by the caller (subgroup_weights()), as parallel.mesh hands the same
        weights to every shard of a batch."""
        if sub_weights is None:
            sub_weights = self.subgroup_weights(generator)
        el, er, all_valid = self.core(proof_bytes, public_inputs, y_hints, sub_weights)
        ok = self._stage("pairing", lambda: cuda_pairing.pairing_check(el, er, self.pair))
        return ok & all_valid

    # -- RLC batched pairing ----------------------------------------------
    _RLC_RECHECK = 128  # rows exactly re-checked in-flight per RLC batch

    def verify_rlc(self, proof_bytes, public_inputs, y_hints=None, group: int = 8,
                   generator: torch.Generator | None = None) -> np.ndarray:
        """Batch verification with ONE pairing check per `group` proofs.

        Each group's pairing sides are aggregated with fresh random 128-bit
        weights: e(sum_b w_b el_b, sG2) e(sum_b w_b er_b, G2) == 1 holds for
        honest rows and fails except with probability <= group / 2^128 when
        any row's own equation fails. The per-row transcript, scalar work and
        decompression validity stay exact per proof, and the rows of a
        failing group are re-checked one by one, so verdicts are exact per
        row. Returns (B,) bool verdicts (numpy). Requires B % group == 0."""
        weights = self.rlc_weights(torch.as_tensor(proof_bytes).shape[0], generator)
        out = self.verify_rlc_device(proof_bytes, public_inputs, weights, y_hints, group=group,
                                     generator=generator)
        return self.rlc_finalize(*out)

    def rlc_weights(self, B: int, generator: torch.Generator | None = None) -> torch.Tensor:
        """Fresh nonzero 128-bit RLC weights (bit 0 set) as (B, 17) canonical
        Fr limbs, int64 on the CPU: from `generator` when given, else from
        the OS's randomness."""
        if generator is not None:
            w = torch.randint(0, 1 << 16, (B, 8), generator=generator, dtype=torch.int64)
        else:
            w = torch.from_numpy(np.frombuffer(secrets.token_bytes(16 * B), dtype="<u2")
                                 .astype(np.int64).reshape(B, 8))
        w[:, 0] |= 1
        return torch.nn.functional.pad(w, (0, FR_SPEC.L - 8))

    def verify_rlc_device(self, proof_bytes, public_inputs, weights, y_hints=None, *,
                          group: int = 8, generator: torch.Generator | None = None):
        """The device leg of verify_rlc: returns (verdicts, n_suspects,
        group_ok, all_valid, el, er, R), R the in-flight re-check width.
        `verdicts` is already exact whenever n_suspects <= R; rlc_finalize
        handles the overflow."""
        B = torch.as_tensor(proof_bytes).shape[0]
        if group < 1 or B % group:
            raise ValueError(f"batch {B} is not a multiple of group {group}")
        el, er, all_valid = self.core(proof_bytes, public_inputs, y_hints,
                                      self.subgroup_weights(generator))
        el_g, er_g = self._stage("rlc_msm", lambda: self._agg(el, er, all_valid, weights, group))
        group_ok = self._stage("pairing", lambda: cuda_pairing.pairing_check(el_g, er_g, self.pair))
        R = min(self._RLC_RECHECK, B)
        verdicts0, n_sus, group_ok, idx, live, el_s, er_s = self._post(
            group_ok, all_valid, el, er, group, R)
        # JaxVerifier gates the re-check pairing on the device (lax.cond);
        # here one host read of the suspect count skips it on clean batches
        if int(n_sus):
            row_ok = self._stage("recheck",
                                 lambda: cuda_pairing.pairing_check(el_s, er_s, self.pair))
            verdicts = self._final(verdicts0, idx, live, row_ok)
        else:
            verdicts = verdicts0
        return verdicts, n_sus, group_ok, all_valid, el, er, R

    def rlc_finalize(self, verdicts, n_sus, group_ok, all_valid, el, er, R: int) -> np.ndarray:
        """Host tail of verify_rlc: exact verdicts out. Only when more than
        R rows sat in failing groups (a flood of bad proofs) does this
        re-check every suspect row, in one more pairing call."""
        verdicts = verdicts.cpu().numpy()
        if int(n_sus) > R:
            group = verdicts.shape[0] // group_ok.shape[0]
            group_ok = group_ok.cpu().numpy()
            all_valid = all_valid.cpu().numpy()
            verdicts = np.repeat(group_ok, group) & all_valid
            suspects = np.nonzero(np.repeat(~group_ok, group) & all_valid)[0]
            verdicts[suspects] = self._recheck_rows(el, er, suspects)
        return verdicts

    def _agg(self, el, er, all_valid, weights, group: int):
        """Per-group RLC aggregation: (B, 3, L) pairing sides -> two (G, 3, L)
        aggregates. Rows with invalid encodings are already rejected; a zero
        weight keeps them from failing their group-mates' aggregate. One MSM
        kernel call (K = group) aggregates both sides, stacked on the batch
        dim."""
        B = el.shape[0]
        G = B // group
        w = torch.where(all_valid[:, None], torch.as_tensor(weights, device=el.device), 0)
        both = torch.cat([el.reshape(G, group, 3, FP_SPEC.L),
                          er.reshape(G, group, 3, FP_SPEC.L)]).contiguous()
        w2 = torch.cat([w.reshape(G, group, FR_SPEC.L)] * 2).contiguous()
        self.msm_term_counts.append(group)
        agg = cuda_curve.msm(both, w2)
        return agg[:G].contiguous(), agg[G:].contiguous()

    def _post(self, group_ok, all_valid, el, er, group: int, R: int):
        """Gather up to R rows of failing groups for the exact re-check; the
        slots past the suspect count carry the identity pair (trivially
        true). Returns (verdicts0, n_sus, group_ok, idx, live, el_s, er_s):
        slot j re-checks row idx[j] where live[j]."""
        suspect = (~group_ok).repeat_interleave(group) & all_valid
        n_sus = suspect.sum()
        # suspects first, in row order (a stable sort, no host sync)
        idx = torch.argsort((~suspect).to(torch.uint8), stable=True)[:R]
        live = torch.arange(R, device=el.device) < n_sus
        el_s = torch.where(live[:, None, None], el[idx], self.ident).contiguous()
        er_s = torch.where(live[:, None, None], er[idx], self.ident).contiguous()
        verdicts0 = group_ok.repeat_interleave(group) & all_valid
        return verdicts0, n_sus, group_ok, idx, live, el_s, er_s

    @staticmethod
    def _final(verdicts0, idx, live, row_ok):
        """Scatter the re-check verdicts of the live slots only (the others
        would alias rows that were not re-checked)."""
        verdicts = verdicts0.clone()
        verdicts[idx[live]] = row_ok[live]
        return verdicts

    def _recheck_rows(self, el, er, suspects) -> np.ndarray:
        """Exact per-row pairing checks of the suspect row indices (the
        kernel takes any number of rows)."""
        idx = torch.as_tensor(suspects, dtype=torch.int64, device=el.device)
        return cuda_pairing.pairing_check(el[idx].contiguous(), er[idx].contiguous(),
                                          self.pair).cpu().numpy()

    # ------------------------------------------------------------------
    def _stage(self, name, fn):
        """Run one stage; with `timings` set, bracket it in CUDA events."""
        if self.timings is None or self.device.type != "cuda":
            return fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.timings.setdefault(name, []).append((start, end))
        return out

    def _fr_from_le_bytes(self, raw):
        """(..., 32) uint8 -> value mod q in Montgomery form."""
        b = raw.to(torch.int64).reshape(*raw.shape[:-1], 16, 2)
        limbs = torch.nn.functional.pad(b[..., 0] | (b[..., 1] << 8), (0, 1))
        return fr.to_mont(limbs)  # tolerates values up to 2^256

    def _fr_from_words(self, w):
        """(..., 8) LE64 digest words -> Fr Montgomery."""
        l16 = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(*w.shape[:-1], 16)
        return fr.to_mont(torch.nn.functional.pad(l16, (0, 1)))

    def _pi_bytes(self, pi_limbs):
        """(..., L) canonical Fr limbs -> (..., 32) LE bytes."""
        l16 = pi_limbs[..., :16]
        return torch.stack([l16 & 0xFF, (l16 >> 8) & 0xFF], -1).reshape(
            *pi_limbs.shape[:-1], 32).to(torch.uint8)

    def transcript_buffer(self, proof, pis):
        """(B, TOTAL) uint8 transcript bytes, in gather form: every byte comes
        from the static template, a static proof offset or a public input."""
        buf = torch.where(self._buf_from_proof, proof[:, self._buf_src], self._template)
        for i, pos in enumerate(self.layout.pi_positions):
            buf[:, pos : pos + 32] = self._pi_bytes(pis[:, i, :])
        return buf.contiguous()

    def core(self, proof, pis, y_hints=None, sub_weights=None):
        """proof bytes -> (el, er, all_valid): the pairing sides and the
        per-row validity of the proof's point encodings (decompression and,
        unless the mode is "off", subgroup membership). sub_weights: the
        aggregate mode's (rounds, n_points) weights (subgroup_weights())."""
        if self.subgroup_check == "aggregate" and sub_weights is None:
            # refuse a silent downgrade of the default strict mode
            raise ValueError("subgroup_check='aggregate' requires sub_weights: pass "
                             "verifier.subgroup_weights() (fresh per batch), or construct "
                             "TorchVerifier(subgroup_check='off'/'exact')")
        plan, lay, vk = self.plan, self.layout, self.plan.vk
        dev = self.device
        proof = torch.as_tensor(proof, device=dev)
        pis = torch.as_tensor(pis, device=dev).to(torch.int64)
        B = proof.shape[0]
        if proof.dtype != torch.uint8 or proof.dim() != 2 or proof.shape[1] != lay.proof_len:
            raise ValueError(f"proofs must be (B, {lay.proof_len}) uint8, got "
                             f"{tuple(proof.shape)} {proof.dtype}")
        if pis.shape != (B, self.n_pi, FR_SPEC.L):
            raise ValueError(f"public inputs must be (B, {self.n_pi}, {FR_SPEC.L})")

        # ---- transcript buffer + all challenges --------------------------
        def transcript():
            buf = self.transcript_buffer(proof, pis)
            h1w, h2w = cuda_blake.transcript_hashes(buf, self._sq_lengths)
            m = self._fr_from_words(torch.stack([h1w, h2w]))
            vals = fr.add(m[0], fr.mul(m[1], self.r256_mont))
            return {name: vals[:, s] for s, (name, _l) in enumerate(lay.squeezes)}

        ch = self._stage("transcript", transcript)

        # ---- parse proof fields ------------------------------------------
        scalars = {}
        if self._sc_idx is not None:
            sc_vals = self._fr_from_le_bytes(proof[:, self._sc_idx])
            scalars = {n: sc_vals[:, i, :] for i, n in enumerate(lay.scalar_offsets)}

        point_names = list(lay.point_offsets)

        hints = None
        if y_hints is not None:
            hints = torch.as_tensor(y_hints, device=dev).to(torch.int64).contiguous()
            if hints.shape != (B, len(point_names), FP_SPEC.L):
                raise ValueError(f"y_hints must be (B, {len(point_names)}, {FP_SPEC.L}), "
                                 f"got {tuple(hints.shape)}")

        def decompress():
            pt_raw = proof[:, self._pt_idx]
            if hints is None:
                sqrt_fn = lambda rhs: cuda_field.fp_pow(rhs.contiguous(), (FP_SPEC.N + 1) >> 2)  # noqa: E731
                return (*tc.decompress(pt_raw, sqrt_fn=sqrt_fn), None)
            if self.subgroup_check == "aggregate":
                # the fused kernel: the subgroup test on the points just decoded
                return cuda_curve.decompress_hinted(pt_raw, hints, sub_weights)
            return (*cuda_curve.decompress_hinted(pt_raw, hints), None)

        pts, pt_valid, sub_ok = self._stage("decompress", decompress)
        points = {n: pts[:, i] for i, n in enumerate(point_names)}
        all_valid = pt_valid.all(-1)
        if self.subgroup_check == "exact":
            # the per-point test in plain torch (the JAX package has no
            # kernel for it either)
            all_valid = all_valid & self._stage("subgroup", lambda: tc.subgroup_check(pts).all(-1))
        elif self.subgroup_check == "aggregate":
            if sub_ok is None:
                sub_ok = self._stage("subgroup", lambda: cuda_curve.aggregate_subgroup_check(
                    pts.contiguous(), sub_weights))
            all_valid = all_valid & sub_ok

        set_points, mo_invs, vanishing_s, xn = self._stage(
            "fr_side", lambda: self._scalar_side(B, ch, scalars, pis))

        def eval_value(ref):
            tag = ref[0]
            if tag == "advice_eval":
                return scalars[f"advice_eval_{ref[1]}"]
            if tag == "fixed_eval":
                return scalars[f"fixed_eval_{ref[1]}"]
            if tag == "perm_z":
                return scalars[f"perm_z_{ref[1]}_{ref[2]}"]
            if tag == "perm_common":
                return scalars[f"perm_common_{ref[1]}"]
            if tag == "vanishing_s":
                return vanishing_s
            if tag == "random_eval":
                return scalars["random_eval"]
            if tag == "lookup":
                return scalars[f"lookup_{ref[1]}_{ref[2]}"]
            raise ValueError(ref)

        def com_terms(ref, coeff):
            """Yield (point_key, coeff) MSM terms; vanishing_g expands into
            the xn^i-scaled quotient splits (extraction/mod.rs:637-686)."""
            tag = ref[0]
            if tag == "vanishing_g":
                c = coeff
                for i in range(plan.num_vanishing_splits):
                    yield (f"split_{i}", c)
                    if i != plan.num_vanishing_splits - 1:
                        c = fr.mul(c, xn)
                return
            if tag not in _COM_KEYS:
                raise ValueError(ref)
            yield (_COM_KEYS[tag].format(*ref[1:]), coeff)

        def resolve_point(key):
            """Static key -> (B, 3, L) points ('#'-prefixed = VK constant)."""
            if key == "#neg_g1":
                return self.neg_g1.expand(B, 3, FP_SPEC.L)
            if key.startswith("#fixed_"):
                return self.fixed_coms[int(key[7:])].expand(B, 3, FP_SPEC.L)
            if key.startswith("#perm_"):
                return self.perm_coms[int(key[6:])].expand(B, 3, FP_SPEC.L)
            return points[key]

        def run_msm(terms, stage="msm"):
            """One MSM over the de-duplicated terms (self.msm: one kernel
            call, or one on each slice of the points; msm_term_counts holds
            the unsharded K)."""
            terms = dedup_terms(terms)
            self.msm_term_counts.append(len(terms))
            pts_arr = torch.stack([resolve_point(k) for k, _c in terms], -3).contiguous()
            coeffs = fr.from_mont(torch.stack([c for _k, c in terms], -2)).contiguous()
            return self._stage(stage, lambda: self.msm(pts_arr, coeffs))

        self.msm_term_counts = []
        if plan.flavor == FLAVOR_HALO2:
            el, er_msm = self._multiopen_halo2(plan, ch, scalars, eval_value, com_terms,
                                               run_msm, points, set_points, mo_invs)
        else:
            el, er_msm = self._multiopen_gwc(plan, ch, eval_value, com_terms, run_msm)
        er = tc.neg(er_msm)
        return el.contiguous(), er.contiguous(), all_valid

    def _rot_point(self, x, rot):
        """The evaluation point of a rotation: x times omega^offset."""
        off = rot_offset(rot, self.plan.vk.blinding_factors)
        return x if off == 0 else fr.mul(x, self.rot_mult[off])

    def _scalar_side(self, B, ch, scalars, pis):
        """The Fr side: one pooled batch inversion, the Lagrange basis and
        the vanishing fold. Returns (set_points, mo_invs, vanishing_s, xn)."""
        plan, vk, dev = self.plan, self.plan.vk, self.device
        x = ch["x"]
        xn = fr.pow(x, vk.n)
        one = self.one_fr.expand(B, FR_SPEC.L)

        # Every Fr inverse the verifier needs (Lagrange-basis denominators,
        # 1/(x^n - 1), multi-open interpolation denominators) depends only on
        # challenges and plan constants, so all of them merge into one
        # Montgomery-trick batch inversion with ONE Fermat ladder (the Fr pow
        # kernel) at the root.
        inv_blocks = []

        def _pool(block):
            start = sum(blk.shape[-2] for blk in inv_blocks)
            inv_blocks.append(block)
            return (start, start + block.shape[-2])

        if self.n_pi:
            inst_rots = self.inst_rotations[: self.n_pi]
            sl_inst = _pool(fr.sub(x[:, None, :], inst_rots[None]))
        sl_van = _pool(fr.sub(x[:, None, :], self.van_rotations[None]))
        sl_xn1 = _pool(fr.sub(xn, one)[:, None, :])

        # the Halo2-book multi-open's interpolation denominators (GWC19 has
        # no x3 and needs no inverse of its own)
        set_points, mo_slices = None, []
        if plan.flavor == FLAVOR_HALO2:
            x3_ch = ch["x3"]
            set_points = [[self._rot_point(x, r) for r in rots] for rots in plan.point_sets]
            for pts_s in set_points:
                dens = []
                for j in range(len(pts_s)):
                    den = None
                    for m in range(len(pts_s)):
                        if m != j:
                            dm = fr.sub(pts_s[j], pts_s[m])
                            den = dm if den is None else fr.mul(den, dm)
                    dens.append(den if den is not None else fr.one((B,), dev))
                z_den = None
                for p in pts_s:
                    t = fr.sub(x3_ch, p)
                    z_den = t if z_den is None else fr.mul(z_den, t)
                mo_slices.append(_pool(torch.stack(dens + [z_den], -2)))

        def root_inv(t):
            return cuda_field.fr_pow(t[:, None, :].contiguous(), Q - 2)[:, 0, :]

        pooled = fr.batch_inv(torch.cat(inv_blocks, -2), dim=-2, inv_fn=root_inv)
        mo_invs = [pooled[:, a:b, :] for (a, b) in mo_slices]
        common = fr.mul(fr.sub(xn, one), self.bary_mont)

        def lagrange_basis(rots, sl):
            # l_i(x) = rot_i * (x^n - 1) * bary / (x - rot_i)
            return fr.mul(fr.mul(pooled[:, sl[0] : sl[1], :], common[:, None, :]), rots[None])

        if self.n_pi:
            instance_eval = fr.dot_lazy(lagrange_basis(inst_rots, sl_inst), fr.to_mont(pis), dim=-2)
        else:
            instance_eval = fr.zeros((B,), dev)

        basis_van = lagrange_basis(self.van_rotations, sl_van)
        bf = vk.blinding_factors
        last_evaluation = basis_van[:, 0, :]
        sum_blind = fr.sum_lazy(basis_van[:, 1 : 1 + bf, :], dim=-2)
        evaluation_at_0 = basis_van[:, 1 + bf, :]
        active_rows = fr.sub(one, fr.add(last_evaluation, sum_blind))

        n_sets = plan.num_permutation_sets
        perm_z_evals = [
            {w: scalars[f"perm_z_{s}_{w}"]
             for w in (["cur", "next", "last"] if s != n_sets - 1 else ["cur", "next"])}
            for s in range(n_sets)
        ]
        lookup_evals = [
            {w: scalars[f"lookup_{i}_{w}"] for w in ["z_cur", "z_next", "a_cur", "a_prev", "s_cur"]}
            for i in range(len(plan.lookups))
        ]
        env = _FrEnv(
            dev,
            vars_={
                "theta": ch.get("theta"),
                "beta": ch.get("beta"),
                "gamma": ch.get("gamma"),
                "x": x,
                "instance_eval": instance_eval,
                "evaluation_at_0": evaluation_at_0,
                "last_evaluation": last_evaluation,
                "active_rows": active_rows,
            },
            advice_evals=[scalars[f"advice_eval_{i}"] for i in range(len(plan.advice_queries))],
            fixed_evals=[scalars[f"fixed_eval_{i}"] for i in range(len(plan.fixed_queries))],
            perm_common_evals=[scalars[f"perm_common_{i}"] for i in range(len(plan.permutation_columns))],
            perm_z_evals=perm_z_evals,
            lookup_evals=lookup_evals,
        )
        h_eval = fr.zeros((B,), dev)
        y = ch["y"]
        for expr in self.exprs:
            h_eval = fr.add(fr.mul(h_eval, y), eval_expr(expr, env))
        vanishing_s = fr.mul(h_eval, pooled[:, sl_xn1[0], :])
        return set_points, mo_invs, vanishing_s, xn

    def _multiopen_halo2(self, plan, ch, scalars, eval_value, com_terms, run_msm, points,
                         set_points, mo_invs):
        """Halo2-book accumulation (Halo2MultiOpenMSM.hs:59-97) assembled as
        one MSM; q-set evals and f_eval are computed on the scalar side.
        `set_points` are the per-set rotated evaluation points and
        `mo_invs[s]` the pooled inverses of [interpolation denominators...,
        prod(x3 - pt)] for set s."""
        x1, x2, x3, x4 = ch["x1"], ch["x2"], ch["x3"], ch["x4"]
        B = x1.shape[0]
        dev = x1.device
        n_sets = len(plan.point_sets)

        x1_powers = [fr.one((B,), dev)]
        for _ in range(plan.x1_powers_count - 1):
            x1_powers.append(fr.mul(x1_powers[-1], x1))
        x4_powers = [fr.one((B,), dev)]
        for _ in range(plan.x4_powers_count - 1):
            x4_powers.append(fr.mul(x4_powers[-1], x4))

        # q-set eval vectors (x1-weighted sums of claimed evals per point)
        members_by_set = [[cd for cd in plan.commitment_data if cd[1] == s] for s in range(n_sets)]
        q_eval_sets = []
        for s, members in enumerate(members_by_set):
            evs = []
            for p_idx in range(len(plan.point_sets[s])):
                terms = torch.stack(
                    [fr.mul(x1_powers[j], eval_value(cd[3][p_idx])) for j, cd in enumerate(members)],
                    -2)
                evs.append(fr.sum_lazy(terms, dim=-2))
            q_eval_sets.append(evs)

        # f_eval: Horner in x2 over reversed sets of
        # (q_eval - r(x3)) / prod(x3 - pt); denominators arrive pre-inverted
        per_set = []
        for s in range(n_sets):
            pts_s, evs, inv_stack = set_points[s], q_eval_sets[s], mo_invs[s]
            r_eval = fr.zeros((B,), dev)  # r(x3): interpolation through (pts_s, evs)
            for j in range(len(pts_s)):
                num = None
                for m in range(len(pts_s)):
                    if m != j:
                        nm = fr.sub(x3, pts_s[m])
                        num = nm if num is None else fr.mul(num, nm)
                if num is None:
                    num = fr.one((B,), dev)
                r_eval = fr.add(r_eval, fr.mul(evs[j], fr.mul(num, inv_stack[:, j, :])))
            q_ev = scalars[f"q_eval_{s}"]
            per_set.append(fr.mul(fr.sub(q_ev, r_eval), inv_stack[:, len(pts_s), :]))
        f_eval = fr.zeros((B,), dev)
        for term in reversed(per_set):
            f_eval = fr.add(fr.mul(f_eval, x2), term)

        # v = sum x4^i (q_evals ++ [f_eval])
        v = fr.zeros((B,), dev)
        for i in range(n_sets):
            v = fr.add(v, fr.mul(x4_powers[i], scalars[f"q_eval_{i}"]))
        v = fr.add(v, fr.mul(x4_powers[n_sets], f_eval))

        # final MSM: sum_s x4^s sum_j x1^j com_{s,j} + x4^n f_comm
        #            + v * (-G1) + x3 * pi
        msm_terms = []
        for s, members in enumerate(members_by_set):
            for j, cd in enumerate(members):
                msm_terms.extend(com_terms(cd[0], fr.mul(x4_powers[s], x1_powers[j])))
        msm_terms.append(("f_commitment", x4_powers[n_sets]))
        msm_terms.append(("#neg_g1", v))
        msm_terms.append(("pi", x3))
        return points["pi"], run_msm(msm_terms)

    def _multiopen_gwc(self, plan, ch, eval_value, com_terms, run_msm):
        """GWC19 accumulation (GwcMultiOpenMSM.hs:96-135), as JaxVerifier's
        _multiopen_gwc: the queries grouped by rotation in first-occurrence
        order; left = sum_i u^i w_i, right = sum_i u^i z_i w_i
        + sum_i u^i sum_j v^j c_ij - (sum_i u^i sum_j v^j e_ij) G1. The two
        sides run as two MSM kernel calls, each de-duplicated on its own."""
        v_ch, u_ch, x = ch["v"], ch["u"], ch["x"]
        B = v_ch.shape[0]
        dev = v_ch.device
        triples = [(q.rot, q.commitment, q.evaluation) for q in plan.all_queries_ordered()]
        left_terms, right_terms = [], []
        u_pow = fr.one((B,), dev)
        final_eval = fr.zeros((B,), dev)
        for g, (rot, members) in enumerate(group_queries_by_rotation(triples)):
            left_terms.append((f"w_{g}", u_pow))
            right_terms.append((f"w_{g}", fr.mul(u_pow, self._rot_point(x, rot))))
            v_pow = fr.one((B,), dev)
            inner = fr.zeros((B,), dev)
            for com, ev in members:
                right_terms.extend(com_terms(com, fr.mul(v_pow, u_pow)))
                inner = fr.add(inner, fr.mul(v_pow, eval_value(ev)))
                v_pow = fr.mul(v_pow, v_ch)
            final_eval = fr.add(final_eval, fr.mul(u_pow, inner))
            u_pow = fr.mul(u_pow, u_ch)
        right_terms.append(("#neg_g1", final_eval))
        return run_msm(left_terms, "msm_left"), run_msm(right_terms, "msm_right")
