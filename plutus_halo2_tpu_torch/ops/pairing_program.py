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
known slots, then one stage of output combinations. Every reference is
resolved when the table is written to one word offset in the kernel's row of
slots (``slot_of``), and a stage's combinations are padded to one length, so
the kernel's operand path reads no bases and takes no branch per term.
``csrc/pairing.cu`` interprets these programs with a group of lanes per
row, the stage's items spread over the lanes; ``interpret_row`` is the same
interpreter on Python integers, so the tables the kernel reads are checked
on the CPU. ``program_stats`` counts a row's critical path: the stages,
product passes, terms and reductions of its slowest lane."""

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

# operand bases of a traced slot reference: the program's three arguments,
# the output staging area, the row's scratch, the constants, this step's
# lines (the doubling lines of this Miller step, the addition lines of this
# one-bit)
ARG0, ARG1, ARG2, STAGE, SCRATCH, CONST, LINE, LINE_ADD = range(8)
PROD, INV, LIN = range(3)  # item kinds

# the row's slots (one Fp each, 12 words), as csrc/pairing.cu lays them out:
# f, m, a chain's cur and acc, the saved c, the affine points, the raw
# coordinates, the constants (copied in at the row's start), this Miller
# step's doubling and addition lines (copied in at each step: per pair lam
# and c, two Fp each), the output staging area, then the scratch
ROW_F, ROW_M, ROW_CUR, ROW_ACC, ROW_CS = 0, 12, 24, 36, 48
ROW_PTS, ROW_RAW, ROW_CONST, ROW_LINE, ROW_LINE_ADD, ROW_STAGE, ROW_SCRATCH = 60, 64, 70, 95, 103, 111, 123
SLOT_WORDS = 12

# program ids, in the order of the table's header
PROG_AFFINE = 0
PROG_MILLER = 1  # + 3 * add + (live mask - 1)
PROG_EASY = 7
PROG_CYC = 8  # + mul
PROG_COMBINE = 10  # + (0: steps 0-1, 1: step 2, 2: steps 3-4)
PROG_CUBE = 13
PROG_TAIL = 14
N_PROGS = 15

# each program's arguments as row slots: the kernel copies a chain's cur into
# ROW_CUR and ROW_ACC before its steps, so every program reads fixed slots
# and a term of the table is one row offset
ARGS = {PROG_AFFINE: (ROW_RAW,), PROG_EASY: (ROW_F,), PROG_CUBE: (ROW_M,), PROG_TAIL: (ROW_CUR, ROW_CS, ROW_F),
        **{pid: (ROW_F, ROW_PTS) for pid in range(PROG_MILLER, PROG_EASY)},
        **{pid: (ROW_ACC, ROW_CUR) for pid in range(PROG_CYC, PROG_CUBE)}}
_BASE_SLOT = {STAGE: ROW_STAGE, SCRATCH: ROW_SCRATCH, CONST: ROW_CONST, LINE: ROW_LINE, LINE_ADD: ROW_LINE_ADD}

# constants (kernel slots): one, then gamma_1 and gamma_2 as (6, 2)
CONST_ONE, CONST_GAM1, CONST_GAM2 = 0, 1, 13
N_CONST = 25
# the ladders in the kernel: per pair the 63 doubling lines (lam, c), then
# the addition lines of the one-bits (lam, c), 4 slots each
N_ADD = BITS.count("1")
LINE_PAIR_STRIDE = (len(BITS) + N_ADD) * 4
# a combination's coefficients: their magnitudes summed over its negative
# terms below COMBO_M (the multiple of p the kernel adds before its one
# reduction), over its positive terms at most COMBO_POS; then the sum with
# COMBO_M p lies in [p, 17 p), below 2^385
COMBO_M, COMBO_POS = 9, 8
# the fewest lanes a row runs with: an inversion stage fits in one pass
MIN_LANES = 16
# a stage's K is padded to a multiple of PAD: the kernel loads a
# combination's terms PAD at a time
PAD = 2


def slot_of(pid: int, base: int, off: int) -> int:
    """The row slot a traced reference (base, off) of program pid names."""
    return (ARGS[pid][base] if base <= ARG2 else _BASE_SLOT[base]) + off


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


def _term(slot: int, coef: int) -> int:
    """A term of the kernel's table: the slot's word offset in the row, then
    the coefficient as a signed byte (0 pads a combination)."""
    if not (abs(coef) < 128 and 0 <= slot < 1 << 16):
        raise ValueError(f"term out of range: slot {slot} coef {coef}")
    return (slot * SLOT_WORDS) << 8 | (coef & 0xFF)


def decode_term(t: int) -> tuple[int, int]:
    """(row slot, coefficient) of a table term."""
    return (t >> 8) // SLOT_WORDS, ((t & 0xFF) ^ 0x80) - 0x80


class _Tables:
    """The programs and their flat int32 table. The table: a header of
    N_PROGS program offsets, then per program [n_stages, n_out, stages...]
    with its stages one after another. A stage is a header word (n_items |
    kind << 8 | K << 10: a stage's items are of one kind) and its items, each
    1 + ops K words (ops 2 for a product, else 1): the row word offset of its
    destination, then per operand K terms (``_term``), padded to the stage's
    largest combination K with zero-coefficient terms. Every reference is
    resolved to a row slot (``slot_of``) when the table is written."""

    def __init__(self):
        self.words = [0] * N_PROGS
        self.scratch = 0
        self.stats: dict = {}
        self.programs: dict = {}

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

        def refs(t):
            return [(*ref(e), d) for e, d in t]

        stages = [(kind_of[meta[by_level[s][0]][0]], [(ref(i), [refs(t) for t in ops[i]]) for i in by_level[s]])
                  for s in range(1, top + 1)]
        stages.append((LIN, [((STAGE, k), [refs(t)]) for k, t in enumerate(outs)]))
        self.programs[pid] = (stages, len(outs))
        every = [t for i in items for t in ops[i]] + outs
        self.stats[pid] = {
            "products": sum(meta[i][0] == "mul" for i in items),
            "inversions": sum(meta[i][0] == "inv" for i in items),
            "linear": sum(meta[i][0] == "lin" for i in items),
            "stages": top + 1, "scratch": nslots,
            "terms": sum(map(len, every)),
            "max_coef": max((abs(d) for t in every for _e, d in t), default=0),
        }

    def encode(self, pid: int):
        """Append program pid to the table."""
        stages, n_out = self.programs[pid]
        w = self.words
        w[pid] = len(w)
        w += [len(stages), n_out]
        for kind, items in stages:
            if len(items) > 0xFF or kind == INV and len(items) > MIN_LANES:
                raise ValueError(f"program {pid}: a stage of {len(items)} items of kind {kind}")
            k = max(len(t) for _dst, ops in items for t in ops)
            k += -k % PAD
            w.append(len(items) | kind << 8 | k << 10)
            for dst, ops in items:
                w.append(slot_of(pid, *dst) * SLOT_WORDS)
                for t in ops:
                    if sum(-c for *_r, c in t if c < 0) >= COMBO_M or sum(c for *_r, c in t if c > 0) > COMBO_POS:
                        raise ValueError(f"program {pid}: a combination's coefficients exceed the reduction's range")
                    w += [_term(slot_of(pid, b, o), c) for b, o, c in t] + [0] * (k - len(t))


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
        lines = torch.cat([S.input(base, (2, 1, 2, 2), [j * 4 + k * 2 + c
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


@functools.lru_cache(maxsize=None)
def _compiled() -> _Tables:
    tables = _Tables()
    for pid in range(N_PROGS):
        _trace(pid, tables)
    for pid in range(N_PROGS):
        tables.encode(pid)
    tables.words += [0] * (-len(tables.words) % 4)  # the kernel copies it in 16-byte words
    return tables


def kernel_tables() -> tuple[np.ndarray, int, int]:
    """(the int32 program table, the scratch slots a row needs, the words
    of the table the kernel holds in shared memory: all of them)."""
    t = _compiled()
    return np.asarray(t.words, dtype=np.int64).astype(np.int32), t.scratch, len(t.words)


def program_refs(pid: int) -> tuple[list, int]:
    """Program pid before its references are resolved: (stages, n_out), a
    stage (kind, items), an item ((base, off) of its destination, its
    operands as [(base, off, coef), ...])."""
    return _compiled().programs[pid]


def row_programs(mask: int = 3) -> list[int]:
    """The programs a row runs in order, with the live points `mask` (1:
    el's, 2: er's, 3: both)."""
    pids = [PROG_AFFINE] + [PROG_MILLER + 3 * (bit == "1") + mask - 1 for bit in BITS] + [PROG_EASY]
    for step in range(5):
        pids += [PROG_CYC + (bit == "1") for bit in BITS] + [PROG_COMBINE + (0, 0, 1, 2, 2)[step]]
    return pids + [PROG_CUBE, PROG_TAIL]


def _stage_path(n: int, kind: int, k: int, lanes: int) -> tuple[int, int, int]:
    """(product passes, terms, reductions) of one stage on the critical lane
    (lane 0, which holds the stage's first item) of a row of `lanes` lanes.
    A product stage runs passes of two items a lane (items i and i + lanes)
    and so four combinations, two when its items fit one pass of single
    items; a linear stage one item a lane, or passes of two when its items
    outnumber the lanes."""
    if kind == PROD:
        passes = -(-n // (2 * lanes))
        return passes, passes * (4 if n > lanes else 2) * k, passes * (4 if n > lanes else 2)
    if n <= lanes:
        return 0, k, 1
    passes = -(-n // (2 * lanes))
    return 0, 2 * passes * k, 2 * passes


def critical_path(pids, lanes: int) -> dict:
    """The critical path of running programs `pids` in order: stages (each a
    barrier), product passes (one f_mul2 each), the terms its combinations
    read (the padding included) and its combinations (one reduction each)."""
    out = {"stages": 0, "product_passes": 0, "terms": 0, "reductions": 0}
    tab = _compiled().words
    for pid in pids:
        at = tab[pid]
        n_stages = tab[at]
        at += 2
        for _ in range(n_stages):
            hdr = tab[at]
            n, kind, k = hdr & 0xFF, hdr >> 8 & 3, hdr >> 10
            passes, terms, red = _stage_path(n, kind, k, lanes)
            out["stages"] += 1
            out["product_passes"] += passes
            out["terms"] += terms
            out["reductions"] += red
            at += 1 + n * (1 + (2 if kind == PROD else 1) * k)
    return out


def program_stats() -> dict:
    """Per program: products, inversions, stages, scratch slots, terms, the
    largest coefficient, and its critical path (``critical_path``) at 32 and
    16 lanes a row; under "row", the critical path of a whole row with two
    live points."""
    t = _compiled()
    out = {pid: dict(st, critical={g: critical_path([pid], g) for g in (32, 16)}) for pid, st in t.stats.items()}
    out["row"] = {g: critical_path(row_programs(), g) for g in (32, 16)}
    return out


def row_slots(scratch: int) -> int:
    return ROW_SCRATCH + scratch


def _words_array(name: str, x: int) -> str:
    body = ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(SLOT_WORDS))
    return f"static __constant__ uint32_t {name}[{SLOT_WORDS}] = {{{body}}};\n"


def kernel_header() -> str:
    """The constants csrc/pairing.cu shares with this module, as C++: the
    row layout, the program ids, the item kinds; the reduction's COMBO_M p
    and 2^384 - p (words) and its divisor (p >> 360) + 1."""
    names = {
        "LINE_PAIR_STRIDE": LINE_PAIR_STRIDE, "PAD": PAD, "PROD": PROD, "INV": INV, "LIN": LIN,
        "ROW_F": ROW_F, "ROW_M": ROW_M, "ROW_CUR": ROW_CUR, "ROW_ACC": ROW_ACC, "ROW_CS": ROW_CS,
        "ROW_PTS": ROW_PTS, "ROW_RAW": ROW_RAW, "ROW_CONST": ROW_CONST, "ROW_LINE": ROW_LINE,
        "ROW_LINE_ADD": ROW_LINE_ADD, "ROW_STAGE": ROW_STAGE, "ROW_SCRATCH": ROW_SCRATCH, "N_CONST": N_CONST,
        "PROG_AFFINE": PROG_AFFINE, "PROG_MILLER": PROG_MILLER,
        "PROG_EASY": PROG_EASY, "PROG_CYC": PROG_CYC, "PROG_COMBINE": PROG_COMBINE, "PROG_CUBE": PROG_CUBE,
        "PROG_TAIL": PROG_TAIL,
    }
    return ("".join(f"static constexpr int PAIR_{k} = {v};\n" for k, v in names.items())
            + _words_array("PAIR_COMBO_MP", COMBO_M * P) + _words_array("PAIR_NEGP", (1 << 384) - P)
            + f"static constexpr uint32_t PAIR_QDIV = 0x{(P >> 360) + 1:x}u;\n")


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


def _run(tab, pid: int, row: list, dst=None):
    """Run program `pid` on the row's slots with the kernel's control flow:
    stage by stage, each item's combinations, then its product, inversion or
    copy; the outputs go to the staging area, then to slot `dst` when given."""
    at = tab[pid]
    n_stages, n_out = tab[at], tab[at + 1]
    at += 2
    for _ in range(n_stages):
        hdr = tab[at]
        n, kind, k = hdr & 0xFF, hdr >> 8 & 3, hdr >> 10
        ops = 2 if kind == PROD else 1
        writes = []
        for i in range(n):
            item = at + 1 + i * (1 + ops * k)
            v = [sum(c * row[s] for s, c in map(decode_term, tab[item + 1 + o * k:item + 1 + (o + 1) * k])) % P
                 for o in range(ops)]
            if kind == PROD:
                x = v[0] * v[1] * _RINV % P
            elif kind == INV:
                x = pow(v[0], P - 2, P) * R_K * R_K % P if v[0] else 0  # Fermat: a R -> a^-1 R
            else:
                x = v[0]
            writes.append((tab[item] // SLOT_WORDS, x))
        for s, x in writes:
            row[s] = x
        at += 1 + n * (1 + ops * k)
    if dst is not None:
        row[dst:dst + n_out] = row[ROW_STAGE:ROW_STAGE + n_out]


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
    row[ROW_CONST:ROW_CONST + N_CONST] = const_ints()
    ladder = np.asarray(lines)
    for c in range(3):
        row[ROW_RAW + 2 * c], row[ROW_RAW + 2 * c + 1] = el[c], er[c]
    live = [row[ROW_RAW + 4 + j] != 0 for j in range(2)]
    mask = live[0] | live[1] << 1
    if not mask:
        return True  # e(O, Q1) e(O, Q2) = 1
    _run(tab, PROG_AFFINE, row, ROW_PTS)
    row[ROW_F:ROW_F + 12] = [kernel_int(1)] + [0] * 11
    n_add = 0
    for i, bit in enumerate(BITS):
        for j in range(2):  # this step's lines into the row
            row[ROW_LINE + 4 * j:ROW_LINE + 4 * j + 4] = [int(v) for v in ladder[j, i].reshape(-1)]
            if bit == "1":
                row[ROW_LINE_ADD + 4 * j:ROW_LINE_ADD + 4 * j + 4] = [
                    int(v) for v in ladder[j, len(BITS) + n_add].reshape(-1)]
        _run(tab, PROG_MILLER + 3 * (bit == "1") + mask - 1, row, ROW_F)
        n_add += bit == "1"
    _run(tab, PROG_EASY, row, ROW_M)
    cur = ROW_M
    for step in range(5):
        row[ROW_CUR:ROW_CUR + 12] = row[ROW_ACC:ROW_ACC + 12] = row[cur:cur + 12]
        for bit in BITS:
            _run(tab, PROG_CYC + (bit == "1"), row, ROW_ACC)
        cur = ROW_CS if step == 2 else ROW_CUR  # m stays for the tail, c after step 2
        _run(tab, PROG_COMBINE + (0, 0, 1, 2, 2)[step], row, cur)
    _run(tab, PROG_CUBE, row, ROW_F)  # m^3 where f was
    _run(tab, PROG_TAIL, row, ROW_ACC)
    return row[ROW_ACC:ROW_ACC + 12] == [kernel_int(1)] + [0] * 11
