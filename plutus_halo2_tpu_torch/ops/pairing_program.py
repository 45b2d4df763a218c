"""The pairing kernel's schedule, its plain version, and the programs the
kernel runs.

The schedule is the Pallas kernel's (``plutus_halo2_tpu/ops/pallas_pairing.py:419``
``make_pairing_check``): projective -> affine by one Fermat inversion per
side; a 63-step Miller loop of complex squarings and sparse (w^0, w^2, w^3)
line products, the addition lines only on the 5 one-bits of |x|; the easy
part f^((p^6 - 1)(p^2 + 1)); the hard part 3h = (x-1)^2 (x+p) (x^2+p^2-1) + 3
as five exp-by-x chains of Granger-Scott cyclotomic squarings; a compare
to 1. Each step is a function of the tower in ``ops/tower.py`` (k12_*),
generic over the field object F.

``pairing_check_schedule`` runs the schedule with the port's ``fp`` on a
batch: the plain version of the kernel's arithmetic, step for step.

``kernel_tables`` traces each step once with a symbolic field, whose values
are integer combinations of slots, into a *program*: stages of independent
Fp products (and Fermat inversions), each operand an integer combination of
known slots, then one stage of output combinations. ``csrc/pairing.cu``
interprets these programs with a group of lanes per row, the stage's items
spread over the lanes; ``interpret_row`` is the same interpreter on Python
integers, so the tables the kernel reads are checked on the CPU."""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch

from ..refimpl.field import P
from . import tower as T
from .limb import FP_SPEC, fp
from .pairing import BITS

# ---------------------------------------------------------------------------
# the schedule, generic over F
# ---------------------------------------------------------------------------


def affine(X, Y, Z, F=fp):
    """Projective (X : Y : Z) -> (x, -y): one Fermat inversion per point (0
    maps to 0, so an identity point gives (0, 0))."""
    zi = F.inv(Z)
    return F.mul(X, zi), F.neg(F.mul(Y, zi))


def miller_step(f, xa, nya, lines, add: bool, live=(True, True), F=fp, inf=None):
    """f^2 times this step's doubling lines (and addition lines where the
    bit of |x| is 1) of the pairs in `live`. xa, nya (..., 2, L): the two
    affine points; lines (..., 2, 4, 2, L): per pair (dbl_lam, dbl_c,
    add_lam, add_c). `inf` (..., 2) masks an identity point's line to 1, as
    the Pallas kernel does; the kernel drops that pair from `live` instead."""
    f = T.k12_sqr(f, F)
    for base in ((0, 2) if add else (0,)):
        for j in range(2):
            if not live[j]:
                continue
            c0 = lines[..., j, base + 1, :, :]
            c2 = T.k2_mul_fp(lines[..., j, base, :, :], xa[..., j, :], F)
            c3 = torch.stack([nya[..., j, :], F.zeros(nya.shape[:-2], nya.device)], -2)
            if inf is not None:
                m = inf[..., j, None, None]
                one2 = T.k12_one(inf.shape[:-1], nya.device, F)[..., 0, :, :]
                c0 = torch.where(m, one2, c0)
                c2 = torch.where(m, torch.zeros_like(c2), c2)
                c3 = torch.where(m, torch.zeros_like(c3), c3)
            f = T.k12_mul_sparse023(f, c0, c2, c3, F)
    return f


def easy_part(f, gam2, F=fp):
    """f^((p^6 - 1)(p^2 + 1))."""
    t = T.k12_mul(T.k12_conj(f, F), T.k12_inv(f, F), F)
    return T.k12_mul(T.k12_frobenius(t, gam2, False, F), t, F)


def cyc_step(acc, cur, mul: bool, F=fp):
    """One step of exp-by-|x|: a cyclotomic squaring, times cur on a one-bit."""
    acc = T.k12_cyc_sqr(acc, F)
    return T.k12_mul(acc, cur, F) if mul else acc


def chain_combine(acc, cur, step: int, gam1, F=fp):
    """Close chain `step` of the hard part: e = conj(acc) = cur^x, then
    e conj(cur) (steps 0, 1), e cur^p (step 2), or e (steps 3, 4)."""
    e = T.k12_conj(acc, F)
    if step <= 1:
        return T.k12_mul(e, T.k12_conj(cur, F), F)
    if step == 2:
        return T.k12_mul(e, T.k12_frobenius(cur, gam1, True, F), F)
    return e


def cube(m, F=fp):
    """m^3."""
    return T.k12_mul(T.k12_sqr(m, F), m, F)


def tail(d, c, m3, gam2, F=fp):
    """d c^(p^2) conj(c) m^3: the hard part's last products."""
    e = T.k12_mul(T.k12_mul(d, T.k12_frobenius(c, gam2, False, F), F), T.k12_conj(c, F), F)
    return T.k12_mul(e, m3, F)


def ladders(prep1, prep2, device) -> torch.Tensor:
    """(2, 63, 4, 2, L) line constants of the two prepared G2 points."""
    return torch.as_tensor(np.stack([
        np.stack([prep[k] for k in ("dbl_lam", "dbl_c", "add_lam", "add_c")], axis=1)
        for prep in (prep1, prep2)]), device=device)


def pairing_check_schedule(el, er, prep1, prep2):
    """(B, 3, L) projective el, er -> (B,) bool: e(el, Q1) e(er, Q2) == 1 by
    the kernel's schedule, with the port's fp."""
    dev = el.device
    pts = torch.stack([el, er], -3)  # (B, 2, 3, L)
    X, Y, Z = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
    inf = fp.is_zero(Z)
    xa, nya = affine(X, Y, Z)
    lines = ladders(prep1, prep2, dev)
    f = T.k12_one(inf.shape[:-1], dev)
    for i, bit in enumerate(BITS):
        f = miller_step(f, xa, nya, lines[:, i], bit == "1", inf=inf)
    gam1, gam2 = (torch.as_tensor(T._GAMMAS[k], device=dev) for k in (1, 2))
    m = cur = easy_part(f, gam2)
    for step in range(5):
        acc = cur
        for bit in BITS:
            acc = cyc_step(acc, cur, bit == "1")
        cur = chain_combine(acc, cur, step, gam1)
        if step == 2:
            c_saved = cur
    out = tail(cur, c_saved, cube(m), gam2)
    return T.fp12_eq(out, T.k12_one(out.shape[:-3], dev))


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

# operand bases of a slot reference: the program's three arguments, the
# output staging area, the row's scratch, the constants, this step's lines
# (the doubling lines of this Miller step, the addition lines of this one-bit)
ARG0, ARG1, ARG2, STAGE, SCRATCH, CONST, LINE, LINE_ADD = range(8)
PROD, INV, LIN = range(3)  # item kinds

# the row's slots (one Fp each, 12 words), as csrc/pairing.cu lays them out
ROW_F, ROW_M, ROW_CUR, ROW_ACC, ROW_CS = 0, 12, 24, 36, 48
ROW_PTS, ROW_RAW, ROW_STAGE, ROW_SCRATCH = 60, 64, 70, 82

# program ids, in the order of the table's header
PROG_AFFINE = 0
PROG_MILLER = 1  # + 3 * add + (live mask - 1)
PROG_EASY = 7
PROG_CYC = 8  # + mul
PROG_COMBINE = 10  # + (0: steps 0-1, 1: step 2, 2: steps 3-4)
PROG_CUBE = 13
PROG_TAIL = 14
N_PROGS = 15

# constants (kernel slots): one, then gamma_1 and gamma_2 as (6, 2)
CONST_ONE, CONST_GAM1, CONST_GAM2 = 0, 1, 13
# the ladders in the kernel: per pair the 63 doubling lines (lam, c), then
# the addition lines of the one-bits (lam, c), 4 slots each
N_ADD = BITS.count("1")
LINE_PAIR_STRIDE = (len(BITS) + N_ADD) * 4


class SymField:
    """A symbolic Fp for tracing a step into a program. A value is a
    (..., NB) int64 vector that holds one integer coefficient on one basis
    entry (or none: the value 0). A basis entry is a slot reference (an
    input) or a node: a product of two entries, an inversion of one, or a
    linear combination of entries (an add or sub of two, the Pallas
    kernel's own operations). Equal nodes are shared; a product with 0 is
    0 and makes no node."""

    NB = 8192

    def __init__(self):
        self.meta: list = []  # ("in", base, off) | ("mul", a, b) | ("inv", a) | ("lin", ((i, c), ...))
        self._key: dict = {}
        self._one = self.input(CONST, (), [CONST_ONE])

    def _new(self, meta) -> int:
        if len(self.meta) >= self.NB:
            raise ValueError("program too large for the symbolic basis")
        self.meta.append(meta)
        return len(self.meta) - 1

    def _get(self, meta) -> int:
        idx = self._key.get(meta)
        if idx is None:
            idx = self._key[meta] = self._new(meta)
        return idx

    def input(self, base: int, shape, offsets=None):
        n = int(np.prod(shape))
        offs = range(n) if offsets is None else list(offsets)
        out = torch.zeros((n, self.NB), dtype=torch.int64)
        for k, o in enumerate(offs):
            out[k, self._new(("in", base, int(o)))] = 1
        return out.reshape(*shape, self.NB)

    def terms(self, x) -> list:
        """(..., NB) values -> per value (entry, coefficient), or None for 0."""
        x = x.reshape(-1, self.NB)
        if bool(((x != 0).sum(-1) > 1).any()):
            raise ValueError("a symbolic value holds more than one entry")
        idx = x.abs().argmax(-1, keepdim=True)
        return [(i, c) if c else None for i, c in zip(idx.flatten().tolist(), x.gather(-1, idx).flatten().tolist())]

    def _apply(self, fn, *xs):
        xs = torch.broadcast_tensors(*xs)
        out = torch.zeros((int(np.prod(xs[0].shape[:-1])), self.NB), dtype=torch.int64)
        for k, args in enumerate(zip(*(self.terms(x) for x in xs))):
            r = fn(*args)
            if r is not None:
                out[k, r[0]] = r[1]
        return out.reshape(xs[0].shape)

    def _lin(self, *vals):
        acc: dict = defaultdict(int)
        for v, sign in vals:
            if v is not None:
                acc[v[0]] += sign * v[1]
        acc = {i: c for i, c in acc.items() if c}
        if not acc:
            return None
        if len(acc) == 1:
            return next(iter(acc.items()))  # a multiple of one entry: a coefficient, no node
        return self._get(("lin", tuple(sorted(acc.items())))), 1

    def add(self, a, b):
        return self._apply(lambda x, y: self._lin((x, 1), (y, 1)), a, b)

    def sub(self, a, b):
        return self._apply(lambda x, y: self._lin((x, 1), (y, -1)), a, b)

    def neg(self, a):
        return -a

    def mul(self, a, b):
        def prod(x, y):
            if x is None or y is None:
                return None
            return self._get(("mul", *sorted((x[0], y[0])))), x[1] * y[1]
        return self._apply(prod, a, b)

    def inv(self, a):
        def inv(x):
            if x is None:
                return None
            src = x[0] if x[1] == 1 else self._get(("lin", (x,)))
            return self._get(("inv", src)), 1
        return self._apply(inv, a)

    def zeros(self, shape, device=None):
        return torch.zeros((*shape, self.NB), dtype=torch.int64)

    def one(self, shape, device=None):
        return self._one.expand(*shape, self.NB).clone()


def _term(base: int, off: int, coef: int) -> int:
    if not (0 < abs(coef) < 128 and 0 <= off < 4096):
        raise ValueError(f"term out of range: base {base} off {off} coef {coef}")
    return ((coef & 0xFF) << 16) | (base << 12) | off


class _Tables:
    """The flat int32 table of all programs: a header of N_PROGS program
    offsets, then per program [n_stages, n_out, stage offsets...], per stage
    [n_items, kind, item offsets...] (a stage's items are of one kind), per item [kind, dst, n, terms...(, n,
    terms...)] with a slot reference (base << 12 | off) as dst and terms
    ((coef & 0xff) << 16 | base << 12 | off)."""

    def __init__(self):
        self.words = [0] * N_PROGS
        self.scratch = 0
        self.stats: dict = {}

    def add(self, pid: int, sym: SymField, outputs):
        """Compile the traced outputs into program `pid`. A linear node used
        once is folded into its user; every other node becomes an item (a
        product, an inversion or a linear combination) whose operands are
        integer combinations of inputs and items. Items run in stages by
        dependency level; scratch slots are reused by liveness."""
        meta = sym.meta
        outs = sym.terms(outputs)
        need, uses, stack = set(), defaultdict(int), [v[0] for v in outs if v]
        for v in outs:
            if v:
                uses[v[0]] += 1

        def operands(i):
            m = meta[i]
            return [j for j, _c in m[1]] if m[0] == "lin" else list(m[1:])

        while stack:
            i = stack.pop()
            if i in need:
                continue
            need.add(i)
            if meta[i][0] != "in":
                for j in operands(i):
                    uses[j] += 1
                    stack.append(j)

        def folded(j):
            return meta[j][0] == "lin" and uses[j] == 1

        @functools.lru_cache(maxsize=None)
        def expand(j) -> tuple:
            """Entry j as a combination of inputs and items."""
            if not folded(j):
                return ((j, 1),)
            acc: dict = defaultdict(int)
            for k, c in meta[j][1]:
                for e, d in expand(k):
                    acc[e] += c * d
            return tuple((e, d) for e, d in sorted(acc.items()) if d)

        def scaled(j, c):
            return tuple((e, c * d) for e, d in expand(j))

        items = sorted(i for i in need if meta[i][0] != "in" and not folded(i))
        ops = {}
        for i in items:
            m = meta[i]
            if m[0] == "lin":
                acc: dict = defaultdict(int)
                for k, c in m[1]:
                    for e, d in scaled(k, c):
                        acc[e] += d
                ops[i] = (tuple((e, d) for e, d in sorted(acc.items()) if d),)
            else:
                ops[i] = tuple(expand(j) for j in m[1:])
        # stages: the products (and inversions) d deep in products run
        # together, after the linear items their operands need; the linear
        # items after them in levels of their own
        depth, lin_level, key = {}, {}, {}
        for i in items:  # operands precede their users in creation order
            deps = [e for t in ops[i] for e, _d in t if e in depth]
            depth[i] = max((depth[e] for e in deps), default=0) + (meta[i][0] != "lin")
            if meta[i][0] == "lin":
                lin_level[i] = 1 + max((lin_level[e] for e in deps if e in lin_level and depth[e] == depth[i]),
                                       default=0)
                key[i] = (depth[i], lin_level[i])
            else:
                key[i] = (depth[i] - 1, 1 << 30)
        order = {k: s + 1 for s, k in enumerate(sorted(set(key.values())))}
        level = {i: order[key[i]] for i in items}
        outs = [scaled(*v) if v else () for v in outs]
        top = max(level.values(), default=0)
        last = defaultdict(int)
        for i in items:
            for t in ops[i]:
                for e, _d in t:
                    last[e] = max(last[e], level[i])
        for t in outs:
            for e, _d in t:
                last[e] = top + 1
        by_level = defaultdict(list)
        for i in items:
            by_level[level[i]].append(i)
        kind_of = {"mul": PROD, "inv": INV, "lin": LIN}
        slot, free, live, nslots = {}, [], set(), 0
        for s in range(1, top + 1):
            for i in sorted(live):
                if last[i] < s:
                    free.append(slot[i])
                    live.discard(i)
            free.sort(reverse=True)
            by_level[s].sort(key=lambda i: (-sum(map(len, ops[i])), i))  # the most terms first
            if len({meta[i][0] for i in by_level[s]}) != 1:
                raise ValueError("a stage mixes item kinds")
            for i in by_level[s]:
                if free:
                    slot[i] = free.pop()
                else:
                    slot[i], nslots = nslots, nslots + 1
                live.add(i)
        self.scratch = max(self.scratch, nslots)

        def ref(e):
            return (SCRATCH, slot[e]) if meta[e][0] != "in" else meta[e][1:]

        def enc(t):
            return [len(t)] + [_term(*ref(e), d) for e, d in t]

        stages = []
        for s in range(1, top + 1):
            stages.append([[kind_of[meta[i][0]], _term(SCRATCH, slot[i], 1) & 0xFFFF, *sum(map(enc, ops[i]), [])]
                           for i in by_level[s]])
        stages.append([[LIN, _term(STAGE, k, 1) & 0xFFFF, *enc(t)] for k, t in enumerate(outs)])
        w = self.words
        w[pid] = len(w)
        head = len(w)
        w += [len(stages), len(outs)] + [0] * len(stages)
        for s, st in enumerate(stages):
            w[head + 2 + s] = len(w)
            at = len(w)
            w += [len(st), st[0][0] if st else LIN] + [0] * len(st)
            for k, item in enumerate(st):
                w[at + 2 + k] = len(w)
                w += item
        every = [t for i in items for t in ops[i]] + outs
        self.stats[pid] = {
            "products": sum(meta[i][0] == "mul" for i in items),
            "inversions": sum(meta[i][0] == "inv" for i in items),
            "linear": sum(meta[i][0] == "lin" for i in items),
            "stages": top + 1, "scratch": nslots,
            "terms": sum(map(len, every)),
            "max_coef": max((abs(d) for t in every for _e, d in t), default=0),
        }


def _fp12_input(sym, base):
    return sym.input(base, (6, 2))


def _gam(sym, at):
    return sym.input(CONST, (6, 2), range(at, at + 12))


def _trace(pid: int, tables: _Tables):
    S = SymField()
    if pid == PROG_AFFINE:
        raw = S.input(ARG0, (3, 2))  # X0 X1 Y0 Y1 Z0 Z1
        xa, nya = affine(raw[0], raw[1], raw[2], S)
        out = torch.stack([xa, nya])
    elif PROG_MILLER <= pid < PROG_EASY:
        add, mask = divmod(pid - PROG_MILLER, 3)
        live = (bool((mask + 1) & 1), bool((mask + 1) & 2))
        pts = S.input(ARG1, (2, 2))  # x0 x1 -y0 -y1
        lines = torch.cat([S.input(base, (2, 1, 2, 2), [j * LINE_PAIR_STRIDE + k * 2 + c
                                                        for j in range(2) for k in range(2) for c in range(2)])
                           .reshape(2, 2, 2, S.NB) for base in (LINE, LINE_ADD)], 1)
        out = miller_step(_fp12_input(S, ARG0), pts[0], pts[1], lines, bool(add), live, S)
    elif pid == PROG_EASY:
        out = easy_part(_fp12_input(S, ARG0), _gam(S, CONST_GAM2), S)
    elif pid in (PROG_CYC, PROG_CYC + 1):
        out = cyc_step(_fp12_input(S, ARG0), _fp12_input(S, ARG1), pid == PROG_CYC + 1, S)
    elif PROG_COMBINE <= pid < PROG_CUBE:
        step = (0, 2, 3)[pid - PROG_COMBINE]
        out = chain_combine(_fp12_input(S, ARG0), _fp12_input(S, ARG1), step, _gam(S, CONST_GAM1), S)
    elif pid == PROG_CUBE:
        out = cube(_fp12_input(S, ARG0), S)
    else:
        out = tail(_fp12_input(S, ARG0), _fp12_input(S, ARG1), _fp12_input(S, ARG2), _gam(S, CONST_GAM2), S)
    tables.add(pid, S, out)


# the programs of the loops (the Miller steps, the chains' cyclotomic steps)
# come first in the table: the kernel copies that head of the table into
# shared memory
HOT = (*range(PROG_MILLER, PROG_EASY), PROG_CYC, PROG_CYC + 1)


@functools.lru_cache(maxsize=None)
def _compiled() -> _Tables:
    tables = _Tables()
    for pid in HOT:
        _trace(pid, tables)
    tables.hot_words = len(tables.words)
    for pid in range(N_PROGS):
        if pid not in HOT:
            _trace(pid, tables)
    return tables


def kernel_tables() -> tuple[np.ndarray, int, int]:
    """(the int32 program table, the scratch slots a row needs, the words
    at the head of the table that hold the HOT programs)."""
    t = _compiled()
    return np.asarray(t.words, dtype=np.int64).astype(np.int32), t.scratch, t.hot_words


def program_stats() -> dict:
    """Per program: products, inversions, stages, scratch slots, terms, the
    largest coefficient and each stage's width."""
    return _compiled().stats


def row_slots(scratch: int) -> int:
    return ROW_SCRATCH + scratch


def kernel_header() -> str:
    """The constants csrc/pairing.cu shares with this module, as C++."""
    names = {
        "ARG0": ARG0, "ARG1": ARG1, "ARG2": ARG2, "STAGE": STAGE, "SCRATCH": SCRATCH, "CONST": CONST,
        "LINE": LINE, "LINE_ADD": LINE_ADD, "LINE_PAIR_STRIDE": LINE_PAIR_STRIDE, "N_ADD": N_ADD, "PROD": PROD, "INV": INV, "LIN": LIN,
        "ROW_F": ROW_F, "ROW_M": ROW_M, "ROW_CUR": ROW_CUR, "ROW_ACC": ROW_ACC, "ROW_CS": ROW_CS,
        "ROW_PTS": ROW_PTS, "ROW_RAW": ROW_RAW, "ROW_STAGE": ROW_STAGE,
        "ROW_SCRATCH": ROW_SCRATCH, "PROG_AFFINE": PROG_AFFINE, "PROG_MILLER": PROG_MILLER,
        "PROG_EASY": PROG_EASY, "PROG_CYC": PROG_CYC, "PROG_COMBINE": PROG_COMBINE, "PROG_CUBE": PROG_CUBE,
        "PROG_TAIL": PROG_TAIL,
    }
    return "".join(f"static constexpr int PAIR_{k} = {v};\n" for k, v in names.items())


# ---------------------------------------------------------------------------
# the interpreter on Python integers (the kernel's control flow)
# ---------------------------------------------------------------------------

R_K = 1 << 384  # the kernel's Montgomery radix
_RINV = pow(R_K, -1, P)


def kernel_int(x: int) -> int:
    """A value in the kernel's domain (x R_K mod p) as an integer."""
    return x * R_K % P


def const_ints() -> list[int]:
    """The constant slots: one, gamma_1 (6, 2), gamma_2 (6, 2), kernel domain."""
    gam = T.host_gamma_ints()
    return [kernel_int(1)] + [kernel_int(c) for k in (1, 2) for pair in gam[k] for c in pair]


def _decode(t: int):
    return (((t >> 16) & 0xFF) ^ 0x80) - 0x80, (t >> 12) & 0xF, t & 0xFFF


def _run(tab, pid, mem, bases, dst):
    """Run program `pid`: mem maps a base id to (list, start); the outputs
    go to the staging area, then to `dst` (a row offset) when given."""
    row = mem[STAGE][0]

    def load(t):
        coef, base, off = _decode(t)
        arr, start = mem[base] if base in (STAGE, SCRATCH, CONST, LINE, LINE_ADD) else (row, bases[base])
        return coef * arr[start + off]

    def combo(at):
        n = tab[at]
        return sum(load(tab[at + 1 + k]) for k in range(n)) % P, at + 1 + n

    head = tab[pid]
    n_stages, n_out = tab[head], tab[head + 1]
    for s in range(n_stages):
        st = tab[head + 2 + s]
        writes = []
        for k in range(tab[st]):
            at = tab[st + 2 + k]
            kind, dst_ref = tab[at], tab[at + 1]
            a, at = combo(at + 2)
            if kind == PROD:
                b, _ = combo(at)
                v = a * b * _RINV % P
            elif kind == INV:
                v = pow(a, P - 2, P) * R_K * R_K % P if a else 0  # Fermat: a R -> a^-1 R
            else:
                v = a
            writes.append((dst_ref, v))
        for dst_ref, v in writes:
            _c, base, off = _decode(dst_ref)
            arr, start = mem[base]
            arr[start + off] = v
    if dst is not None:
        stage = mem[STAGE][1]
        row[dst : dst + n_out] = row[stage : stage + n_out]


def compact_ladder(lines: np.ndarray) -> np.ndarray:
    """(2, 63, 4, 2, ...) ladders -> the kernel's (2, 63 + N_ADD, 2, 2, ...):
    per pair the doubling lines of every step, then the addition lines of
    the one-bit steps (the others are the dummy line 1)."""
    ones = [i for i, bit in enumerate(BITS) if bit == "1"]
    return np.concatenate([lines[:, :, 0:2], lines[:, ones, 2:4]], axis=1)


def interpret_row(tab, scratch: int, el: list[int], er: list[int], lines: np.ndarray) -> bool:
    """One row of the kernel on Python integers: el, er the projective
    points' coordinates (X, Y, Z) as kernel-domain integers; lines the
    compact ladder (compact_ladder) of kernel-domain integers. Returns the
    verdict."""
    row = [0] * row_slots(scratch)
    consts = const_ints()
    ladder = [int(v) for v in np.asarray(lines).reshape(-1)]
    mem = {STAGE: (row, ROW_STAGE), SCRATCH: (row, ROW_SCRATCH), CONST: (consts, 0)}
    for c in range(3):
        row[ROW_RAW + 2 * c], row[ROW_RAW + 2 * c + 1] = el[c], er[c]
    live = [row[ROW_RAW + 4 + j] != 0 for j in range(2)]
    mask = live[0] | live[1] << 1
    if not mask:
        return True  # e(O, Q1) e(O, Q2) = 1
    _run(tab, PROG_AFFINE, mem, {ARG0: ROW_RAW}, ROW_PTS)
    row[ROW_F] = kernel_int(1)
    for i, bit in enumerate(BITS):
        mem[LINE] = (ladder, 4 * i)
        mem[LINE_ADD] = (ladder, 4 * (len(BITS) + BITS[:i].count("1")))
        _run(tab, PROG_MILLER + 3 * (bit == "1") + mask - 1, mem, {ARG0: ROW_F, ARG1: ROW_PTS}, ROW_F)
    _run(tab, PROG_EASY, mem, {ARG0: ROW_F}, ROW_M)
    cur = ROW_M
    for step in range(5):
        acc = cur
        for bit in BITS:
            _run(tab, PROG_CYC + (bit == "1"), mem, {ARG0: acc, ARG1: cur}, ROW_ACC)
            acc = ROW_ACC
        dst = ROW_CS if step == 2 else ROW_CUR  # m stays for the tail, c after step 2
        _run(tab, PROG_COMBINE + (0, 0, 1, 2, 2)[step], mem, {ARG0: ROW_ACC, ARG1: cur}, dst)
        cur = dst
    _run(tab, PROG_CUBE, mem, {ARG0: ROW_M}, ROW_F)
    _run(tab, PROG_TAIL, mem, {ARG0: cur, ARG1: ROW_CS, ARG2: ROW_F}, ROW_ACC)
    return row[ROW_ACC : ROW_ACC + 12] == [kernel_int(1)] + [0] * 11
