"""The Fr glue's field ops as hand-written kernels (``csrc/fr_glue.cu``),
one launch an op: ``mul``, ``add``, ``sub``, ``sum_lazy`` and ``dot_lazy``
over the port's int64 (..., 17) Montgomery limbs, each result the plain
version's limb for limb (``limb.mont_mul``, ``add``, ``sub``, ``sum_lazy``,
``dot_lazy``). ``limb.fr`` sends an op on a CUDA tensor here and keeps the
plain functions for the CPU (``limb.FrField``); this module takes CUDA
tensors only.

An operand is read where it lies: the wrapper broadcasts the operands'
leading dims, coalesces the output's dims (dropping those of size 1,
merging neighbours that every operand steps through evenly) and hands the
kernel each operand's strides over at most three of them, 0 where it
broadcasts, and over the reduced dim. An operand whose limb dim is not
contiguous is copied first, and so are both where more than three dims
remain; ``layout_copies`` counts those copies (the verifier's bodies make
none). The output is a new contiguous tensor.

Counters, plain integers as every kernel wrapper keeps: each op's
``launches`` (``mul.launches``, ...; ``models/programs.COUNTED`` adds a
program's on each replay), ``layout_copies``, and ``plain_on_cuda``: the
Fr ops that reached a plain function of ``ops/limb.py`` with a CUDA tensor
(``limb.mont_mul``, ``add`` and ``sub`` count them), which the verifier's
bodies keep at 0. ``THREADS``: threads a block, read at each launch."""

from __future__ import annotations

import ctypes

import torch

from . import _build

L = 17
THREADS = 128
OPS = ("mul", "add", "sub", "sum_lazy", "dot_lazy")  # ph2_fr_glue's op codes, in order
layout_copies = 0
plain_on_cuda = 0


def _broadcast(*shapes):
    """The broadcast of leading shapes (torch.broadcast_shapes imports
    torch._refs on its first call: seconds of a run's set-up)."""
    n = max(len(s) for s in shapes)
    out = []
    for dims in zip(*[(1,) * (n - len(s)) + tuple(s) for s in shapes]):
        sizes = set(dims) - {1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _coalesce(sizes, strides):
    """The output's dims of size > 1, neighbours merged where every operand
    steps through the outer one as through the inner one times its size:
    [(size, [stride of each operand])]."""
    dims = []
    for i, n in enumerate(sizes):
        if n == 1:
            continue
        st = [s[i] for s in strides]
        if dims and all(ps == s * n for ps, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    return dims


def _copied(ops, fn):
    """ops with fn applied to each distinct tensor (sum_lazy's b is its a),
    each copy it makes counted."""
    global layout_copies
    done = {}
    for t in ops:
        if id(t) not in done:
            done[id(t)] = c = fn(t)
            layout_copies += c.data_ptr() != t.data_ptr()
    return [done[id(t)] for t in ops]


def _dims(ops, lead, dim):
    """(dims, k, ks): the output's coalesced dims with each operand's
    strides, the reduced length and each operand's stride over it."""
    strides = [list(t.expand(*lead, L).stride()[:-1]) for t in ops]
    sizes = list(lead)
    k, ks = 1, [0, 0]
    if dim is not None:
        k = sizes.pop(dim)
        ks = [s.pop(dim) for s in strides]
    return _coalesce(sizes, strides), k, ks


def layout(a, b, dim=None):
    """(a, b, out_shape, geom): the operands as the kernel reads them (the
    same tensors unless copied), the output's shape, and ph2_fr_glue's 12
    geometry values: n, d1, d2, k, then a's and b's strides over the leading
    dims 0-2 and the reduced dim. `dim`: the reduced dim of the broadcast
    (..., 17) shape (sum_lazy, dot_lazy), or None."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int64 or t.dim() < 1 or t.shape[-1] != L:
            raise ValueError(f"{name}: expected int64 (..., {L}) limbs, got {t.dtype} {tuple(t.shape)}")
    lead = _broadcast(a.shape[:-1], b.shape[:-1])
    out_lead = lead
    if dim is not None:
        dim = dim % (len(lead) + 1)
        if dim == len(lead):
            raise ValueError("the limb dim cannot be reduced")
        out_lead = lead[:dim] + lead[dim + 1 :]
    ops = [a, b]
    if any(t.stride(-1) != 1 for t in ops):  # an element's limbs are read as one row
        ops = _copied(ops, lambda t: t if t.stride(-1) == 1 else t.contiguous())
    dims, k, ks = _dims(ops, lead, dim)
    if len(dims) > 3:
        # both operands contiguous at the broadcast shape leave at most two
        # dims, one each side of the reduced one
        ops = _copied(ops, lambda t: t.expand(*lead, L).contiguous())
        dims, k, ks = _dims(ops, lead, dim)
    dims = [(1, [0, 0])] * (3 - len(dims)) + dims
    geom = [dims[0][0] * dims[1][0] * dims[2][0], dims[1][0], dims[2][0], k]
    for j in range(2):
        geom += [dims[0][1][j], dims[1][1][j], dims[2][1][j], ks[j]]
    return ops[0], ops[1], (*out_lead, L), geom


def _launch(fn, a, b, dim=None):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"expected CUDA tensors on one device, got {a.device} and {b.device}")
    a, b, shape, geom = layout(a, b, dim)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if out.numel():
        g = (ctypes.c_int64 * len(geom))(*geom)
        _build.check(_build.library().ph2_fr_glue(OPS.index(fn.__name__), _build.ptr(a), _build.ptr(b),
                                                  _build.ptr(out), g, THREADS, _build.stream_ptr()),
                     f"ph2_fr_glue {fn.__name__}")
        fn.launches += 1
    return out


def mul(a, b):
    """a b / 2^272 mod q (limb.mont_mul)."""
    return _launch(mul, a, b)


def add(a, b):
    """a + b mod q of canonical a, b (limb.add)."""
    return _launch(add, a, b)


def sub(a, b):
    """a - b mod q of canonical a, b (limb.sub)."""
    return _launch(sub, a, b)


def sum_lazy(a, dim=-2):
    """The sum over `dim` mod q (limb.sum_lazy)."""
    return _launch(sum_lazy, a, a, dim)


def dot_lazy(a, b, dim=-2):
    """The sum over `dim` of the products a b / 2^272, mod q (limb.dot_lazy)."""
    return _launch(dot_lazy, a, b, dim)


for _f in (mul, add, sub, sum_lazy, dot_lazy):
    _f.launches = 0
