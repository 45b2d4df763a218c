"""ATMS — aggregate threshold multisignature circuits: the port's copy of
``plutus_halo2_tpu/models/atms.py``.

Native equivalents of the reference's AtmsSignatureCircuit /
AtmsLookupCircuit (src/circuits/atms_circuit.rs:23-159,
src/circuits/atms_with_lookups_circuit.rs:21-316). The reference delegates its
gates to IOG's external atms-halo2 crate; this module implements the same
statement natively on a halo2wrong-style main gate:

    public inputs (pks_comm, msg, threshold); the prover knows n Jubjub
    public keys and >= threshold Schnorr signatures on msg such that
    pks_comm = Rescue(pk_1.u, ..., pk_n.u).

Statement pieces, all over the BLS12-381 scalar field:
  - main gate: q_a a + q_b b + q_c c + q_d d + q_e e + q_ab ab + q_cd cd
    + q_const = 0 over 5 advice columns (degree 3);
  - PI gate: q_pi * (a - I(x)) binds advice cells to the instance column;
  - complete twisted-Edwards adds for Jubjub (refimpl/jubjub.py);
  - Rescue-Prime sponge with in-circuit inverse S-box (witness y, y^5 = x);
  - per-party indicator bits, Schnorr check gated by the bit, threshold
    count with a bit-decomposed slack (count - threshold >= 0).

The *_with_lookups variant bolts a pow2 range-check lookup onto the slack
bits, mirroring atms_with_lookups_circuit.rs:34-36 (NB_POW2RANGE_COLS = 1).

The structure (``spec``, ``num_public_inputs``) does not depend on the
parties, so one construction serves every party count for
``plan_from_vk``: AtmsCircuit([(0, 1)] * 2, [None] * 2, 0, 1) gives the
plan of the 408-party set as well. ``assign`` needs the real party data
(``prepare_test_signatures``).
"""

from __future__ import annotations

from ..refimpl import jubjub as jj
from ..refimpl import rescue as rs
from ..refimpl.cs import ADVICE, Assignment, CircuitSpec
from ..refimpl.field import Q
from .plan import ROT_CUR, e_add, e_const, e_mul, e_neg, e_sub

# fixed-column indices
QA, QB, QC, QD, QE, QAB, QCD, QCONST, QPI, QTAG, QTVAL = range(11)
_ADV = 5

SLACK_BITS = 8  # supports n < 256 parties


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


class _Builder:
    """Row-emitting helper over the main gate. Values are tracked as
    (int value, cell) pairs; every placement copy-constrains to the source."""

    def __init__(self, asn: Assignment, start_row: int):
        self.asn = asn
        self.row = start_row

    def emit(self, slots, q):
        """slots: dict col_idx -> (value, src_cell_or_None); q: dict fixed_idx
        -> coeff. Returns dict col_idx -> cell."""
        r = self.row
        cells = {}
        for col, (val, src) in slots.items():
            self.asn.assign_advice(col, r, val % Q)
            cells[col] = (ADVICE, col, r)
            if src is not None:
                self.asn.copy(src, cells[col])
        for fi, coeff in q.items():
            self.asn.assign_fixed(fi, r, coeff % Q)
        self.row += 1
        return cells

    # -- primitive ops (each returns (value, cell)) --------------------------
    def mul(self, x, y):
        out = x[0] * y[0] % Q
        cells = self.emit(
            {0: (x[0], x[1]), 1: (y[0], y[1]), 2: (out, None)},
            {QAB: 1, QC: Q - 1},
        )
        return (out, cells[2])

    def lin(self, terms, const=0):
        """out = sum coeff*x + const; at most 4 terms."""
        assert len(terms) <= 4
        out = (sum(cf * x[0] for cf, x in terms) + const) % Q
        slots = {}
        q = {QCONST: const, QE: Q - 1}
        for i, (cf, x) in enumerate(terms):
            slots[i] = (x[0], x[1])
            q[[QA, QB, QC, QD][i]] = cf
        slots[4] = (out, None)
        cells = self.emit(slots, q)
        return (out, cells[4])

    def boolean(self, bit_val):
        """Witness a fresh boolean: b*b - b = 0."""
        cells = self.emit(
            {0: (bit_val, None), 1: (bit_val, None)}, {QAB: 1, QA: Q - 1}
        )
        self.asn.copy(cells[0], cells[1])
        return (bit_val, cells[0])

    def assert_zero_product(self, b, x):
        """b * x = 0."""
        self.emit({0: (b[0], b[1]), 1: (x[0], x[1])}, {QAB: 1})

    def const(self, v):
        """Witness a constant cell: a - v = 0."""
        cells = self.emit({0: (v % Q, None)}, {QA: 1, QCONST: (-v) % Q})
        return (v % Q, cells[0])

    def pi_row(self, value):
        """A q_pi row binding column a to the instance column at this row."""
        cells = self.emit({0: (value, None)}, {QPI: 1})
        return (value % Q, cells[0])

    # -- Edwards ops ---------------------------------------------------------
    def ed_add(self, p1, p2):
        (x1, y1), (x2, y2) = p1, p2
        t = self.mul(x1, x2)
        u = self.mul(y1, y2)
        p3 = self.mul(x1, y2)
        q3 = self.mul(y1, x2)
        w = self.mul(t, u)
        xv, yv = jj.add((x1[0], y1[0]), (x2[0], y2[0]))
        # x3 + D*x3*w - p3 - q3 = 0
        cx = self.emit(
            {0: (xv, None), 1: (w[0], w[1]), 2: (p3[0], p3[1]), 3: (q3[0], q3[1])},
            {QA: 1, QAB: jj.D, QC: Q - 1, QD: Q - 1},
        )
        # y3 - D*y3*w - u - t = 0
        cy = self.emit(
            {0: (yv, None), 1: (w[0], w[1]), 2: (u[0], u[1]), 3: (t[0], t[1])},
            {QA: 1, QAB: (Q - jj.D) % Q, QC: Q - 1, QD: Q - 1},
        )
        return ((xv, cx[0]), (yv, cy[0]))

    def ed_assert_on_curve(self, p):
        x, y = p
        t1 = self.mul(x, x)
        t2 = self.mul(y, y)
        t3 = self.mul(t1, t2)
        # -t1 + t2 - D*t3 - 1 = 0  (a = -1 curve equation)
        self.emit(
            {0: (t1[0], t1[1]), 1: (t2[0], t2[1]), 2: (t3[0], t3[1])},
            {QA: Q - 1, QB: 1, QC: (Q - jj.D) % Q, QCONST: Q - 1},
        )

    def ed_identity(self):
        return (self.const(0), self.const(1))

    def bits_of(self, x, nbits):
        """Witness an nbits little-endian decomposition of x (MSB-first
        recombination chain, equality-constrained to x's cell)."""
        bits = [(x[0] >> i) & 1 for i in range(nbits)]
        bit_cells = [self.boolean(b) for b in bits]
        acc = self.const(0)
        for bc in reversed(bit_cells):
            acc = self.lin([(2, acc), (1, bc)])
        self.asn.copy(acc[1], x[1])
        return bit_cells

    def ed_mul_base(self, base_pt, bit_cells):
        """Fixed-base scalar mul: acc += b_j * (2^j * base) — no doublings,
        the 2^j multiples are circuit constants."""
        acc = self.ed_identity()
        mult = base_pt
        for bc in bit_cells:
            gx, gy = mult
            xa = self.lin([(gx, bc)])
            ya = self.lin([((gy - 1) % Q, bc)], const=1)
            acc = self.ed_add(acc, (xa, ya))
            mult = jj.add(mult, mult)
        return acc

    def ed_mul_var(self, p, bit_cells):
        """Variable-base scalar mul: LSB-first running double chain."""
        acc = self.ed_identity()
        cur = p
        for i, bc in enumerate(bit_cells):
            xv, yv = cur
            xa = self.mul(bc, xv)
            # ya = 1 + b*yv - b
            yav = (1 + bc[0] * yv[0] - bc[0]) % Q
            cy = self.emit(
                {0: (bc[0], bc[1]), 1: (yv[0], yv[1]), 2: (yav, None), 3: (bc[0], bc[1])},
                {QAB: 1, QC: Q - 1, QD: Q - 1, QCONST: 1},
            )
            acc = self.ed_add(acc, (xa, (yav, cy[2])))
            if i != len(bit_cells) - 1:
                cur = self.ed_add(cur, cur)
        return acc

    # -- Rescue ---------------------------------------------------------------
    def sbox(self, x):
        t = self.mul(x, x)
        f = self.mul(t, t)
        return self.mul(f, x)

    def inv_sbox(self, x):
        yv = pow(x[0], rs.ALPHA_INV, Q)
        y = self.emit({0: (yv, None)}, {})  # free witness, constrained below
        y = (yv, y[0])
        t = self.mul(y, y)
        f = self.mul(t, t)
        x2 = self.mul(f, y)
        self.asn.copy(x2[1], x[1])
        return y

    def rescue_permute(self, state):
        s = list(state)
        for r in range(rs.ROUNDS):
            s = [self.sbox(x) for x in s]
            s = [
                self.lin(
                    [(rs.MDS[i][j], s[j]) for j in range(rs.M)],
                    const=rs.RC[2 * r * rs.M + i],
                )
                for i in range(rs.M)
            ]
            s = [self.inv_sbox(x) for x in s]
            s = [
                self.lin(
                    [(rs.MDS[i][j], s[j]) for j in range(rs.M)],
                    const=rs.RC[(2 * r + 1) * rs.M + i],
                )
                for i in range(rs.M)
            ]
        return s

    def rescue_hash(self, inputs):
        """Sponge, rate 2, 10* padding — mirrors refimpl/rescue.hash_fr."""
        buf = list(inputs) + [self.const(1)]
        while len(buf) % rs.RATE:
            buf.append(self.const(0))
        state = [self.const(0) for _ in range(rs.M)]
        for i in range(0, len(buf), rs.RATE):
            state = [
                self.lin([(1, state[j]), (1, buf[i + j])]) for j in range(rs.RATE)
            ] + state[rs.RATE:]
            state = self.rescue_permute(state)
        return state[0]


class AtmsCircuit:
    """t-of-n aggregate threshold multisignature verification circuit.

    Construct with prepare_test_signatures()-style data; public inputs are
    [pks_comm, msg, threshold] (reference atms_circuit.rs:110-114)."""

    num_public_inputs = 3
    with_lookup = False

    def __init__(self, pks, sigs, msg, threshold):
        """pks: [(u, v)] Jubjub points; sigs: [None | (R, s)] aligned with
        pks; msg: Fr; threshold: int <= #non-None sigs."""
        self.pks = pks
        self.sigs = sigs
        self.msg = msg % Q
        self.threshold = threshold
        self.pks_comm = rs.hash_fr([u for u, _v in pks])
        self.spec = _main_gate_spec(self.with_lookup)

    def public_inputs(self):
        return [self.pks_comm, self.msg, self.threshold]

    def assign(self, asn: Assignment):
        bld = _Builder(asn, 0)

        # rows binding the public inputs (q_pi gate); I(x) carries
        # [pks_comm, msg, threshold] at rows 0..2 (must coincide with where
        # the prover lays out the instance column values)
        pi_comm = bld.pi_row(self.pks_comm)
        pi_msg = bld.pi_row(self.msg)
        pi_thresh = bld.pi_row(self.threshold)

        # witness PKs, on-curve checks, and the Rescue commitment
        pk_cells = []
        for u, v in self.pks:
            xu = bld.emit({0: (u, None)}, {})
            xv = bld.emit({0: (v, None)}, {})
            pk = ((u, xu[0]), (v, xv[0]))
            bld.ed_assert_on_curve(pk)
            pk_cells.append(pk)
        comm = bld.rescue_hash([pk[0] for pk in pk_cells])
        asn.copy(comm[1], pi_comm[1])

        # per-party indicator + gated Schnorr check
        ind_bits = []
        for pk, sig in zip(pk_cells, self.sigs):
            if sig is None:
                R, s = jj.IDENTITY, 0
                bit = 0
            else:
                R, s = sig
                bit = 1
            b = bld.boolean(bit)
            ind_bits.append(b)
            rx = bld.emit({0: (R[0], None)}, {})
            ry = bld.emit({0: (R[1], None)}, {})
            Rc = ((R[0], rx[0]), (R[1], ry[0]))
            bld.ed_assert_on_curve(Rc)
            sc = bld.emit({0: (s, None)}, {})
            s_cell = (s, sc[0])
            c_val = rs.hash_fr([R[0], pk[0][0], self.msg])
            c_cell = bld.rescue_hash([Rc[0], pk[0], pi_msg])
            assert c_cell[0] == c_val
            s_bits = bld.bits_of(s_cell, 253)
            c_bits = bld.bits_of(c_cell, 255)
            sG = bld.ed_mul_base(jj.GEN, s_bits)
            cPK = bld.ed_mul_var(pk, c_bits)
            rhs = bld.ed_add(Rc, cPK)
            dx = bld.lin([(1, sG[0]), (Q - 1, rhs[0])])
            dy = bld.lin([(1, sG[1]), (Q - 1, rhs[1])])
            bld.assert_zero_product(b, dx)
            bld.assert_zero_product(b, dy)

        # threshold: count - threshold = slack, slack >= 0 via bit range
        count = bld.const(0)
        for b in ind_bits:
            count = bld.lin([(1, count), (1, b)])
        slack = bld.lin([(1, count), (Q - 1, pi_thresh)])
        if self.with_lookup:
            self._slack_bits_lookup(bld, slack)
            # table rows for the range lookup: (tag=1, value in {0, 1});
            # every other row's (1, advice5=0) hits the (1, 0) entry
            asn.assign_fixed(QTAG, bld.row, 1)
            asn.assign_fixed(QTVAL, bld.row, 0)
            asn.assign_fixed(QTAG, bld.row + 1, 1)
            asn.assign_fixed(QTVAL, bld.row + 1, 1)
            asn.rows_used = max(asn.rows_used, bld.row + 2)
        else:
            bld.bits_of(slack, SLACK_BITS)

    def _slack_bits_lookup(self, bld, slack):
        """Lookup-variant slack range check: bits placed in the dedicated
        looked-up column (advice 5) and recombined."""
        bit_vals = [(slack[0] >> i) & 1 for i in range(SLACK_BITS)]
        cells = []
        for bv in bit_vals:
            c = bld.emit({5: (bv, None)}, {})
            cells.append((bv, c[5]))
        acc = bld.const(0)
        for bc in reversed(cells):
            acc = bld.lin([(2, acc), (1, bc)])
        bld.asn.copy(acc[1], slack[1])
        return cells


class AtmsLookupCircuit(AtmsCircuit):
    """ATMS + a range-check lookup column (the reference's
    atms_with_lookups_circuit.rs bolts one pow2range lookup column on)."""

    with_lookup = True


def prepare_test_signatures(num_parties: int, threshold: int, msg: int,
                            seed: bytes = b"atms"):
    """Keypairs, `threshold` signatures on msg, Rescue PK commitment —
    the analog of the reference's prepare_test_signatures
    (atms_circuit.rs:125-159)."""
    msg %= Q
    keys = [jj.keygen(seed + i.to_bytes(4, "little")) for i in range(num_parties)]
    pks = [pk for _sk, pk in keys]
    sigs = []
    for i, (sk, _pk) in enumerate(keys):
        if i < threshold:
            sigs.append(jj.sign(sk, msg, rs.hash_fr, seed))
        else:
            sigs.append(None)
    pks_comm = rs.hash_fr([u for u, _v in pks])
    return pks, sigs, pks_comm
