"""Stage-level probe of the port: the counterpart of the JAX package's
``tools/perf_probe.py``. Times each verifier stage, and the Montgomery
product plain and through its kernel, at one batch size.

    python3 -m plutus_halo2_tpu_torch.tools.perf_probe [BATCH] [stage...] [--device cpu] [--trace DIR]

Stages (default: mul chain pairing msm blake decompress sqrtp verify):
  mul         the Fp Montgomery product, plain (``limb.mont_mul``) and through
              the field test kernel (``cuda_field.fp_mont_mul``);
  chain       1000 dependent products, plain and through the kernel;
  blake       plain ``blake2b_256`` on (BATCH, 1152) bytes;
  decompress  hintless decompression of 16 points per row, the hintless
              decompress kernel (``cuda_curve.decompress_hintless``);
  sqrtp       the Fp pow kernel, exponent (p + 1) / 4, width 16;
  msm         the plain MSM; msmp, msmp5 the MSM kernel at 4- and 5-bit
              windows (K = $PROBE_MSM_K, default 24);
  verify      ``TorchVerifier.verify`` in the hintless aggregate mode;
  verifyh     the default mode, with y-hints; core: ``core()`` hinted and
              hintless (everything but the pairing);
  subk        the aggregate subgroup kernel (K = $PROBE_SUB_K, default 16,
              $PROBE_SUB_ROUNDS rounds, default 2), row 1 holding a point
              outside G1, held against its plain version too;
  pairing     the plain Miller loop and pairing check; pairingp the pairing
              kernel, with row 1 corrupted to exercise the reject path.

Each stage is timed as the median of 3 calls after a first one (CUDA events
on the card, the host clock on the CPU: what a call costs its caller) and,
on the card, by the device time of all the kernels it launches
(``utils.profiling.device_ms`` over 5 more calls, whose count of kernels
is not held to a per-call count: a stage launches up to ~20,000); it checks its result against the
port's ``refimpl`` (Python integers), the verifier stages against the
committed simple_mul artifacts' verdicts (the last row the tampered proof
when BATCH >= 2); a wrong result raises. ``--trace DIR`` records one more
call of the verifyh stage with ``torch.profiler`` into DIR/trace.json.gz
and prints the card's busy share of it (the profiler slows the host, so the
traced call's share is below an untraced one's); on the card a trace with
no device activity raises. Runs on the card unless
``--device cpu`` asks for the plain versions; raises without a card."""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import time

import numpy as np
import torch

from ..models.verifier_torch import resolve_device
from ..ops import cuda_curve, cuda_field, cuda_pairing
from ..ops import curve as tc
from ..ops import limb
from ..ops import pairing as tp
from ..ops.blake2b import blake2b_256
from ..refimpl import curve as rc
from ..refimpl.field import P, Q, fr_inv
from ..utils.profiling import call_ms, card_line, device_busy_us, device_ms, torch_trace

STAGES = ("mul", "chain", "blake", "decompress", "sqrtp", "msm", "msmp", "msmp5", "verify", "verifyh",
          "core", "subk", "pairing", "pairingp")
DEFAULT_STAGES = ("mul", "chain", "pairing", "msm", "blake", "decompress", "sqrtp", "verify")
SPEC = limb.FP_SPEC


def _check(ok, what: str):
    if not bool(ok):
        raise RuntimeError(f"perf_probe: {what}")


def _nonsubgroup_point() -> tuple[int, int]:
    """A valid E(Fp) point outside G1 (nonzero h-torsion)."""
    x = 100
    while True:
        rhs = (x**3 + 4) % P
        y = pow(rhs, (P + 1) >> 2, P)
        if y * y % P == rhs and not rc.g1_in_subgroup((x, y)):
            return x, y
        x += 1


def _rows(limbs: np.ndarray, B: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.stack([limbs] * B)).to(dev)


class _Probe:
    def __init__(self, B: int, dev, trace_dir=None):
        self.B, self.dev, self.trace_dir = B, dev, trace_dir
        self.results: dict = {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def timeit(self, name: str, fn, trace: bool = False):
        """fn's median ms of 3 calls after a first one; returns its first
        output. With `trace` and a trace directory, one more call is
        recorded by the profiler."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        first_s = time.perf_counter() - t0
        ms = statistics.median(call_ms(fn, self.dev) for _ in range(3))
        self.results[name] = ms
        dev = ""
        if self.dev.type == "cuda":
            self.results[name + " device"] = dev_ms = device_ms(fn, None, calls=5, exact_count=False)
            dev = f"  device={dev_ms:10.3f} ms"
        print(f"{name:36s} run={ms:10.3f} ms{dev}  first={first_s:7.2f} s", flush=True)
        if trace and self.trace_dir:
            with torch_trace(self.trace_dir) as path:
                traced_ms = call_ms(fn, self.dev)
            try:
                busy, window = device_busy_us(path)
            except ValueError as e:
                if self.dev.type == "cuda":  # the card ran and the trace missed it
                    raise
                print(f"  device busy share: not measured ({e}; {path})", flush=True)
            else:
                self.results["busy_share"] = busy / window
                print(f"  device busy share {busy / window:.4f}: {busy / 1e3:.3f} ms busy in a "
                      f"{window / 1e3:.3f} ms traced window (the traced call {traced_ms:.3f} ms, "
                      f"untraced {ms:.3f} ms; {path})", flush=True)
        return out

    # -- stages ------------------------------------------------------------
    def mul(self):
        a, b = _rows(SPEC.to_mont(3), self.B, self.dev), _rows(SPEC.to_mont(5), self.B, self.dev)
        want = _rows(SPEC.to_mont(15), self.B, self.dev)
        out = self.timeit("mont_mul plain x1", lambda: limb.mont_mul(SPEC, a, b))
        _check(torch.equal(out, want), "plain Montgomery product wrong")
        out = self.timeit("mont_mul kernel x1", lambda: cuda_field.fp_mont_mul(a, b))
        _check(torch.equal(out, want), "Montgomery product kernel wrong")

    def chain(self):
        a, b = _rows(SPEC.to_mont(3), self.B, self.dev), _rows(SPEC.to_mont(5), self.B, self.dev)
        want = _rows(SPEC.to_mont(3 * pow(5, 1000, P)), self.B, self.dev)

        def chain(mul):
            def f():
                c = a
                for _ in range(1000):
                    c = mul(c, b)
                return c
            return f

        _check(torch.equal(self.timeit("1000 seq muls plain", chain(lambda x, y: limb.mont_mul(SPEC, x, y))),
                           want), "plain product chain wrong")
        _check(torch.equal(self.timeit("1000 seq muls kernel", chain(cuda_field.fp_mont_mul)), want),
               "kernel product chain wrong")

    def blake(self):
        msgs = torch.zeros((self.B, 1152), dtype=torch.uint8, device=self.dev)
        out = self.timeit("blake2b_256 1152B", lambda: blake2b_256(msgs))
        want = np.frombuffer(hashlib.blake2b(bytes(1152), digest_size=32).digest(), np.uint8)
        _check(torch.equal(out.cpu(), torch.from_numpy(np.stack([want] * self.B))), "blake2b_256 wrong")

    def decompress(self):
        p7 = rc.g1_mul(rc.G1_GEN, 7)
        enc = np.frombuffer(rc.g1_compress(p7), np.uint8)
        raw = torch.from_numpy(np.broadcast_to(enc, (self.B, 16, 48)).copy()).to(self.dev)
        pts, valid = self.timeit("decompress 16 pts (hintless kernel)", lambda: cuda_curve.decompress_hintless(raw))
        _check(valid.all(), "decompress rejected a valid point")
        _check(torch.equal(pts, pts[:1, :1].expand_as(pts)) and tc.host_point_from_mont(pts[0, 0].cpu().numpy())
               == p7, "decompress wrong")

    def sqrtp(self):
        width, e = 16, (P + 1) >> 2
        vals = _rows(np.stack([SPEC.to_mont(7 + i) for i in range(width)]), self.B, self.dev)
        out = self.timeit(f"pow kernel sqrt w={width}", lambda: cuda_field.fp_pow(vals, e))
        want = np.stack([SPEC.to_mont(pow(7 + i, e, P)) for i in range(width)])
        _check(torch.equal(out.cpu(), torch.from_numpy(np.stack([want] * self.B))), "pow kernel wrong")

    def msm(self, stages):
        K = int(os.environ.get("PROBE_MSM_K", "24"))
        base = [rc.g1_mul(rc.G1_GEN, i + 2) for i in range(K)]
        pts = torch.from_numpy(np.stack([np.stack([tc.host_point_to_mont(p) for p in base])] * self.B)).to(self.dev)
        scs = torch.from_numpy(np.stack([np.stack([limb.FR_SPEC.encode(12345 + i) for i in range(K)])] * self.B))
        scs = scs.to(self.dev)
        want = rc.g1_msm([12345 + i for i in range(K)], base)
        wx, wy = _rows(SPEC.to_mont(want[0]), self.B, self.dev), _rows(SPEC.to_mont(want[1]), self.B, self.dev)
        for stage, label, fn in (
            ("msm", f"msm plain K={K}", lambda: tc.msm(pts, scs)),
            ("msmp", f"msm kernel K={K} w=4", lambda: cuda_curve.msm(pts, scs, wbits=4)),
            ("msmp5", f"msm kernel K={K} w=5", lambda: cuda_curve.msm(pts, scs, wbits=5)),
        ):
            if stage in stages:
                x, y, inf = tc.to_affine(self.timeit(label, fn))
                _check(torch.equal(x, wx) and torch.equal(y, wy) and not inf.any(), f"{label} wrong")

    def _verifier_inputs(self):
        from ..models.verifier_torch import TorchVerifier
        from ..utils.artifacts import load_set

        plan, good, bad, pis = load_set("simple_mul")
        good, bad = np.frombuffer(good, np.uint8), np.frombuffer(bad, np.uint8)
        ver = TorchVerifier(plan, device=self.dev)
        batch = np.stack([good] * self.B).copy()
        want = np.ones(self.B, bool)
        if self.B >= 2:
            batch[-1], want[-1] = bad, False
        proofs = torch.from_numpy(batch).to(self.dev)
        pis_t = torch.from_numpy(ver.encode_public_inputs([pis] * self.B)).to(self.dev)
        hints = torch.from_numpy(ver.compute_y_hints(batch)).to(self.dev)
        return ver, proofs, pis_t, hints, want

    def verify(self, stages):
        ver, proofs, pis, hints, want = self._verifier_inputs()
        gen = torch.Generator().manual_seed(7)
        if "verify" in stages:
            out = self.timeit("full verify (hintless aggregate)", lambda: ver.verify(proofs, pis, None, gen))
            _check(np.array_equal(out.cpu().numpy(), want), "hintless verify verdicts wrong")
        if "verifyh" in stages:
            out = self.timeit("full verify (y-hints)", lambda: ver.verify(proofs, pis, hints, gen), trace=True)
            _check(np.array_equal(out.cpu().numpy(), want), "hinted verify verdicts wrong")
        if "core" in stages:
            for label, h in (("core (no pairing, hinted)", hints), ("core (no pairing, hintless)", None)):
                valid = self.timeit(label, lambda: ver.core(proofs, pis, h, ver.subgroup_weights(gen)))[2]
                _check(valid.cpu().numpy()[want].all(), f"{label} rejected an honest row")

    def subk(self):
        Ks = int(os.environ.get("PROBE_SUB_K", "16"))
        rounds = int(os.environ.get("PROBE_SUB_ROUNDS", "2"))
        pts = np.stack([np.stack([tc.host_point_to_mont(rc.g1_mul(rc.G1_GEN, i + 2)) for i in range(Ks)])] * self.B)
        pts[1 % self.B, Ks // 2] = tc.host_point_to_mont(_nonsubgroup_point())  # row 1 outside G1
        pts = torch.from_numpy(pts).to(self.dev)
        w = tc.subgroup_weights(Ks, rounds, torch.Generator().manual_seed(1))
        out = self.timeit(f"subgroup kernel K={Ks} r={rounds}", lambda: cuda_curve.aggregate_subgroup_check(pts, w))
        want = np.ones(self.B, bool)
        want[1 % self.B] = False
        _check(np.array_equal(out.cpu().numpy(), want), f"subgroup kernel wrong: {out[:4].tolist()}")
        _check(torch.equal(out, cuda_curve.aggregate_subgroup_check_plain(pts, w)),
               "subgroup kernel differs from its plain version")

    def pairing(self, stages):
        tau = 0xDEADBEEF
        poly = lambda t: (3 * t * t + 7) % Q  # noqa: E731
        z, yv = 5, poly(5)
        a = (poly(tau) - yv) * fr_inv(tau - z) % Q
        W = rc.g1_mul(rc.G1_GEN, a)
        er = rc.g1_mul(rc.G1_GEN, (-tau * a) % Q)  # e(W, tau G2) e(er, G2) == 1
        prep1, prep2 = tp.prepare_g2(rc.g2_mul(rc.G2_GEN, tau)), tp.prepare_g2(rc.G2_GEN)
        if "pairing" in stages:
            elx, ely = _rows(SPEC.to_mont(W[0]), self.B, self.dev), _rows(SPEC.to_mont(W[1]), self.B, self.dev)
            erx, ery = _rows(SPEC.to_mont(er[0]), self.B, self.dev), _rows(SPEC.to_mont(er[1]), self.B, self.dev)
            inf = torch.zeros(self.B, dtype=torch.bool, device=self.dev)
            pairs = [((elx, ely, inf), prep1), ((erx, ery, inf), prep2)]
            self.timeit("miller (2 pairs)", lambda: tp.miller_prepared(pairs))
            out = self.timeit("pairing_check (2 pairs)", lambda: tp.pairing_check(pairs))
            _check(out.all(), "plain pairing check rejected a true pair")
        if "pairingp" in stages:
            el = np.stack([tc.host_point_to_mont(W)] * self.B)
            el[1 % self.B] = tc.host_point_to_mont(rc.g1_mul(rc.G1_GEN, 99))  # row 1 corrupted
            el_t = torch.from_numpy(el).to(self.dev)
            er_t = _rows(tc.host_point_to_mont(er), self.B, self.dev)
            pp = cuda_pairing.PreparedPair(prep1, prep2)
            out = self.timeit("pairing kernel check", lambda: cuda_pairing.pairing_check(el_t, er_t, pp))
            want = np.ones(self.B, bool)
            want[1 % self.B] = False
            _check(np.array_equal(out.cpu().numpy(), want), f"pairing kernel wrong: {out[:4].tolist()}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=256, help="rows per stage (default 256)")
    ap.add_argument("stages", nargs="*", help=f"any of {' '.join(STAGES)}")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: cuda)")
    ap.add_argument("--trace", default=None, metavar="DIR", help="profile the verifyh stage into DIR")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; choose from {' '.join(STAGES)}")
    stages = set(args.stages) or set(DEFAULT_STAGES)
    dev = resolve_device(args.device)
    print(f"device={dev} batch={args.batch} card={card_line(dev)}", flush=True)
    pr = _Probe(args.batch, dev, args.trace)
    for name in ("mul", "chain", "blake", "decompress", "sqrtp", "subk"):
        if name in stages:
            getattr(pr, name)()
    if stages & {"msm", "msmp", "msmp5"}:
        pr.msm(stages)
    if stages & {"verify", "verifyh", "core"}:
        pr.verify(stages)
    if stages & {"pairing", "pairingp"}:
        pr.pairing(stages)
    return pr.results


if __name__ == "__main__":
    main()
