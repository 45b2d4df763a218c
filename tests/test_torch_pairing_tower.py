"""The pairing kernel's formulas and schedule on the CPU: the port's mirrors
of the Pallas tower (plutus_halo2_tpu_torch/ops/tower.py k2_* / k6_* / k12_*)
held exactly, as canonical integers, against plutus_halo2_tpu/ops/
pallas_pairing.py's k*_ functions under jax.jit with kfp; the kernel's
schedule (ops/pairing_program.py, its plain version and the interpreter of
the very tables csrc/pairing.cu reads) against ops/pairing's
pairing_check_projective on true, false and identity rows."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from plutus_halo2_tpu.ops import pallas_pairing as kp  # noqa: E402
from plutus_halo2_tpu.ops.pallas_core import FP24_SPEC, kfp  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing as tp  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing_program as prog  # noqa: E402
from plutus_halo2_tpu_torch.ops import tower as tt  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, limbs_to_int  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402

B = 2
P = FP_SPEC.N


def _ints(rng, shape):
    return np.array([int.from_bytes(rng.bytes(48), "big") % P for _ in range(int(np.prod(shape)))],
                    dtype=object).reshape(shape)


def _port(vals):
    """(B, ..., ) ints -> (B, ..., L) port Montgomery limbs."""
    return torch.from_numpy(np.stack([FP_SPEC.to_mont(int(v)) for v in vals.reshape(-1)])
                            .reshape(*vals.shape, FP_SPEC.L))


def _kernel(vals):
    """(B, ...) ints -> (..., L24, B) the Pallas kernel's R24 layout."""
    arr = np.stack([FP24_SPEC.to_mont(int(v)) for v in vals.reshape(-1)]).reshape(*vals.shape, FP24_SPEC.L)
    return np.moveaxis(arr, 0, -1).astype(np.uint32)


def _from_port(t):
    return np.array([FP_SPEC.from_mont_int(r) for r in t.reshape(-1, FP_SPEC.L).numpy()],
                    dtype=object).reshape(t.shape[:-1])


def _from_kernel(a):
    a = np.moveaxis(np.asarray(jax.jit(kfp.canon)(a)), -1, 0)  # (B, ..., L24)
    return np.array([FP24_SPEC.from_mont_int(r) for r in a.reshape(-1, FP24_SPEC.L)],
                    dtype=object).reshape(a.shape[:-1])


def _fpinv(v):
    return kfp.pow_static(v, P - 2)


# name -> (shapes of the Fp-int inputs without B, port function, Pallas function)
FORMULAS = {
    "k2_sqr": (((2,),), tt.k2_sqr, partial(kp.k2_sqr, kfp)),
    "k6_mul": (((3, 2), (3, 2)), tt.k6_mul, partial(kp.k6_mul, kfp)),
    "k12_mul": (((6, 2), (6, 2)), tt.k12_mul, partial(kp.k12_mul, kfp)),
    "k12_sqr": (((6, 2),), tt.k12_sqr, partial(kp.k12_sqr, kfp)),
    "k12_cyc_sqr": (((6, 2),), tt.k12_cyc_sqr, partial(kp.k12_cyc_sqr, kfp)),
    "k12_mul_sparse023": (((6, 2), (2,), (2,), (2,)), tt.k12_mul_sparse023, partial(kp.k12_mul_sparse023, kfp)),
    "k12_inv": (((6, 2),), tt.k12_inv, lambda a: kp.k12_inv(kfp, a, _fpinv)),
}


@pytest.mark.parametrize("name", list(FORMULAS))
def test_tower_formula_matches_pallas(name):
    """Each mirrored formula equals the Pallas kernel's on seeded inputs,
    exactly, as canonical integers (the Pallas values are lazy in [0, 2p))."""
    shapes, port_fn, pallas_fn = FORMULAS[name]
    rng = np.random.default_rng(sorted(FORMULAS).index(name) + 11)
    ins = [_ints(rng, (B, *s)) for s in shapes]
    got = _from_port(port_fn(*map(_port, ins)))
    want = _from_kernel(jax.jit(pallas_fn)(*map(_kernel, ins)))
    assert got.shape == want.shape and (got == want).all()


def test_frobenius_and_conj_match_pallas():
    rng = np.random.default_rng(5)
    a = _ints(rng, (B, 6, 2))
    assert (_from_port(tt.k12_conj(_port(a))) == _from_kernel(jax.jit(partial(kp.k12_conj, kfp))(_kernel(a)))).all()
    for k in (1, 2):
        gam = torch.as_tensor(tt._GAMMAS[k])
        gam_k = _kernel(np.array([[tt.host_gamma_ints()[k][i][c] for c in range(2)] for i in range(6)],
                                 dtype=object)[None])  # (6, 2, L24, 1)
        got = _from_port(tt.k12_frobenius(_port(a), gam, bool(k % 2)))
        want = _from_kernel(jax.jit(partial(kp.k12_frobenius, kfp, odd=bool(k % 2)))(_kernel(a), gam_k))
        assert (got == want).all(), k


def test_cyclotomic_squaring_squares_after_the_easy_part():
    """On an element of the cyclotomic subgroup (the easy part of a random
    f), Granger-Scott squaring equals the generic one."""
    f = _port(_ints(np.random.default_rng(9), (B, 6, 2)))
    m = prog.easy_part(f, torch.as_tensor(tt._GAMMAS[2]))
    assert torch.equal(tt.k12_cyc_sqr(m), tt.k12_sqr(m))
    assert torch.equal(tt.k12_mul(f, tt.k12_inv(f)), tt.k12_one((B,), "cpu"))


def _rows():
    """(el, er, pair, want): a true KZG-style pair, a false one, the
    identity on either side, and (O, O)."""
    s = 0xC0FFEE
    pair = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, s)), tp.prepare_g2(rc.G2_GEN))
    a = rc.g1_mul(rc.G1_GEN, 11)
    el = [a, rc.g1_mul(rc.G1_GEN, 5), None, a, None]
    er = [rc.g1_neg(rc.g1_mul(a, s)), rc.g1_mul(rc.G1_GEN, 7), rc.g1_mul(rc.G1_GEN, 3), None, None]
    el_t = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in el]))
    er_t = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in er]))
    # another projective representative of the first row: (sX : sY : sZ)
    el_t[0] = tc.fp.mul(el_t[0], torch.from_numpy(FP_SPEC.to_mont(0xBEEF)))
    return el_t, er_t, pair, [True, False, False, False, True]


@pytest.fixture(scope="module")
def rows():
    el, er, pair, want = _rows()
    assert tp.pairing_check_projective(el, er, pair.prep1, pair.prep2).tolist() == want
    return el, er, pair, want


def test_schedule_matches_projective_check(rows):
    el, er, pair, want = rows
    assert prog.pairing_check_schedule(el, er, pair.prep1, pair.prep2).tolist() == want


def test_kernel_tables_interpreted_match_projective_check(rows):
    """The program table the kernel reads, run on Python integers with the
    kernel's control flow, slot layout and compact ladders."""
    el, er, pair, want = rows
    tab, scratch, _hot = prog.kernel_tables()
    tab = tab.tolist()
    words = pair.lines.view(np.uint32).astype(object)
    lines = sum(words[..., w] << (32 * w) for w in range(12))
    rinv = pow(FP_SPEC.R_mod, -1, P)

    def kint(limbs):
        return limbs_to_int(limbs.numpy()) * rinv % P * prog.R_K % P

    got = [prog.interpret_row(tab, scratch, [kint(el[b, c]) for c in range(3)], [kint(er[b, c]) for c in range(3)],
                              lines) for b in range(len(want))]
    assert got == want


def test_programs_keep_the_pallas_stacks():
    """Fp products per program: the Pallas kernel's stacks (a line's c3 has
    a zero Fp component, so its 13 Fp2 products are 36 Fp products)."""
    stats = prog.program_stats()
    sqr, line, mul, cyc = 36, 2 + 36, 54, 18
    assert stats[prog.PROG_MILLER + 2]["products"] == sqr + 2 * line  # both pairs live
    assert stats[prog.PROG_MILLER]["products"] == sqr + line
    assert stats[prog.PROG_MILLER + 5]["products"] == sqr + 4 * line  # with the addition lines
    assert stats[prog.PROG_CYC]["products"] == cyc
    assert stats[prog.PROG_CYC + 1]["products"] == cyc + mul
    assert stats[prog.PROG_CUBE]["products"] == sqr + mul
    assert stats[prog.PROG_AFFINE]["inversions"] == 2 and stats[prog.PROG_EASY]["inversions"] == 1
    _tab, scratch, tab_words = prog.kernel_tables()
    assert prog.row_slots(scratch) * 48 < 16384  # a row's shared memory
    # the ladders, the whole table and the most rows a block holds, in the
    # 227 KB of shared memory a block can have
    ladder_words = 2 * prog.LINE_PAIR_STRIDE * 12
    assert 4 * (ladder_words + tab_words + cuda_pairing.MAX_ROWS_PER_BLOCK * prog.row_slots(scratch) * 12) <= 232448


def test_kernel_tables_resolve_every_reference():
    """Every term of the table names the slot its traced reference (base,
    offset) resolves to, with its coefficient, in order; a stage's header
    holds its items, kind and K, the largest combination rounded up to PAD,
    and the padding terms carry coefficient 0. A row with two live points
    keeps the critical path of 3,345 stages and 560 product passes at 32
    lanes."""
    tab, _scratch, tab_words = prog.kernel_tables()
    tab = tab.tolist()
    assert tab_words == len(tab) and len(tab) % 4 == 0
    padded = 0
    for pid in range(prog.N_PROGS):
        stages, n_out = prog.program_refs(pid)
        at = tab[pid]
        assert tab[at:at + 2] == [len(stages), n_out]
        at += 2
        for kind, items in stages:
            n, k = len(items), max(len(t) for _dst, ops in items for t in ops)
            k += -k % prog.PAD
            assert tab[at] == n | kind << 8 | k << 10
            at += 1
            for dst, ops in items:
                assert tab[at] == prog.slot_of(pid, *dst) * 12
                at += 1
                for t in ops:
                    got = [prog.decode_term(x) for x in tab[at:at + k]]
                    assert got[:len(t)] == [(prog.slot_of(pid, b, o), c) for b, o, c in t]
                    assert all(c == 0 for _slot, c in got[len(t):])
                    padded += k - len(t)
                    at += k
    assert padded > 0
    row = prog.program_stats()["row"]
    assert (row[32]["stages"], row[32]["product_passes"]) == (3345, 560)
    assert row[16]["stages"] == 3345 and row[32]["reductions"] < row[32]["terms"]


def test_compact_ladder_keeps_the_addition_lines_of_the_one_bits():
    lines = np.arange(2 * 63 * 4 * 2).reshape(2, 63, 4, 2)
    c = prog.compact_ladder(lines)
    ones = [i for i, b in enumerate(tp.BITS) if b == "1"]
    assert c.shape == (2, 63 + len(ones), 2, 2)
    assert (c[:, :63] == lines[:, :, :2]).all() and (c[:, 63:] == lines[:, ones, 2:]).all()
