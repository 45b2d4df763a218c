"""Kernel-vs-plain parity of the CUDA kernels at small, ragged shapes (any
B, any K): each kernel's wrapper on CUDA tensors against its plain PyTorch
version on the same inputs, exactly (the MSM, at both window widths, limb
for limb against the plain version of its decomposition and in affine
coordinates against the per-point MSM; the aggregate subgroup verdicts on
rows whose points all decode, against the plain version of the kernels'
decomposition and the JAX package's algorithm; the pow kernel on 0, 1 and
N - 1; the hintless decompress kernel's points and flags; B ragged against the rows a block each launcher derives; the
tensor-core probe kernels bit for bit), the point-sharded
MSM (parallel/mesh.shard_map_msm) on a virtual mesh of the card against the unsharded kernel,
the verifier's modes and verify_rlc on the card against the CPU, the
captured programs against the eager form (over alternating batches, two
replays back to back before a sync) and the pairing kernel's enable flag, and the
prover's four Fr polynomial kernels (csrc/poly.cu) at ragged sizes, word
for word against their plain versions.

These need a CUDA device and nvcc (sm_90a) and skip without them; run them
on the GPU machine with ``python -m pytest tests/test_torch_kernels.py -m gpu
--noconftest`` (``--noconftest`` where JAX is not installed: the suite's
conftest configures JAX).
``chip_smoke.py`` runs the same comparisons at the main path's shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.ops import cuda_blake, cuda_curve, cuda_field, cuda_mma, cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_poly  # noqa: E402
from plutus_halo2_tpu_torch.ops import poly as tpoly  # noqa: E402
from plutus_halo2_tpu_torch.ops import curve as tc  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing as tp  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.tools.pairing_probe import S, check_rows  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _canon(spec, shape, seed, dev):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(2 * spec.L), "little") % spec.N for _ in range(n)]
    vals[0] = 0
    return torch.from_numpy(np.stack([spec.encode(v) for v in vals]).reshape(*shape, spec.L)).to(dev)


@pytest.mark.parametrize("spec", [FP_SPEC, FR_SPEC], ids=["fp", "fr"])
def test_mont_mul_kernel(dev, spec):
    a, b = _canon(spec, (37,), 1, dev), _canon(spec, (37,), 2, dev)
    kern = cuda_field.fp_mont_mul if spec is FP_SPEC else cuda_field.fr_mont_mul
    assert torch.equal(kern(a, b), cuda_field.mont_mul_plain(a, b, spec))


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
@pytest.mark.parametrize("spec", [FP_SPEC, FR_SPEC], ids=["fp", "fr"])
def test_mont_mul_kernel_ragged(dev, spec, n):
    """The Montgomery-product kernel at counts ragged against its threads a
    block, in one and several blocks, on slabs 8 bytes past a 16-byte
    boundary too (views from row 1), with 0, 1 and N - 1 as limbs and in
    the Montgomery domain times every other value, limb for limb against
    the plain product."""
    edge = torch.from_numpy(np.stack([spec.encode(v) for v in (0, 1, spec.N - 1)]
                                     + [spec.to_mont(v) for v in (1, spec.N - 1)])).to(dev)
    a, b = _canon(spec, (n + 1,), 3 + n, dev), _canon(spec, (n + 1,), 4 + n, dev)
    k = min(len(edge), n)
    a[1 : 1 + k], b[1 + n - k :] = edge[:k], edge[:k]
    if n > 2 * len(edge):
        b[1 : 1 + len(edge)] = edge.flip(0)
    kern = cuda_field.fp_mont_mul if spec is FP_SPEC else cuda_field.fr_mont_mul
    for x, y in ((a[:n], b[:n]), (a[1:], b[1:]), (a[1:], b[:n])):
        assert torch.equal(kern(x, y), cuda_field.mont_mul_plain(x, y, spec)), x.data_ptr() % 16


def _pow_case(which, shape, seed, dev):
    """(x, exponent, kernel wrapper, spec): canonical random values with 0,
    1 and N - 1 in the Montgomery domain and the values whose limbs are 1
    and N - 1 among them."""
    if which == "fr_inverse":
        spec, e, kern = FR_SPEC, FR_SPEC.N - 2, cuda_field.fr_pow
    else:
        spec, e, kern = FP_SPEC, (FP_SPEC.N + 1) >> 2, cuda_field.fp_pow
    x = _canon(spec, shape, seed, dev).reshape(-1, spec.L)
    special = [spec.to_mont(1), spec.to_mont(spec.N - 1), spec.encode(1), spec.encode(spec.N - 1)]
    x[1 : 1 + len(special)] = torch.from_numpy(np.stack(special)).to(dev)
    return x.reshape(*shape, spec.L), e, kern, spec


@pytest.mark.parametrize("which,shape", [("fr_inverse", (37, 1)), ("fr_inverse", (1024, 1)),
                                         ("fp_sqrt", (13, 3)), ("fp_sqrt", (1024, 10))])
def test_pow_kernel(dev, which, shape):
    """The verifier's two exponents at ragged and at the main path's shapes,
    limb for limb against the plain version."""
    x, e, kern, spec = _pow_case(which, shape, 3 + shape[0], dev)
    assert torch.equal(kern(x, e), cuda_field.pow_plain(x, spec, e))


@pytest.mark.parametrize("which", ["fr_inverse", "fp_sqrt"])
def test_pow_kernel_lane_groups(dev, which):
    """Element counts ragged against the elements a block the launcher
    fixes, in one and several blocks: the plain version's limbs."""
    for n in (5, 9, 111, 1031):
        x, e, kern, spec = _pow_case(which, (n,), 11 + n, dev)
        assert torch.equal(kern(x, e), cuda_field.pow_plain(x, spec, e)), n


@pytest.mark.parametrize("B,K", [(1, 1), (37, 3), (13, 5)])
def test_block_size_keeps_results(dev, B, K):
    """The one-thread-per-item kernel, the unfused decompress kernel, at
    point counts ragged against its threads a block, in one and several
    blocks: the plain version's points and flags."""
    raw, hints, _kinds = _grid(B, K, 10 + B, ["go", "gox"])
    raw_t, hints_t = torch.from_numpy(raw).to(dev), torch.from_numpy(hints).to(dev)
    got = cuda_curve.decompress_hinted(raw_t, hints_t)
    want = cuda_curve.decompress_hinted_plain(raw_t, hints_t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_transcript_kernel(dev):
    rng = np.random.default_rng(5)
    lengths = [1, 128, 129, 300, 1275]
    buf = torch.from_numpy(rng.integers(0, 256, size=(37, 1280), dtype=np.uint8)).to(dev)
    got = cuda_blake.transcript_hashes(buf, lengths)
    want = cuda_blake.transcript_hashes_plain(buf, lengths)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


SIMPLE_MUL_LENGTHS = (264, 265, 266, 463, 562, 1124, 1125, 1175, 1275)  # models/layout.py


@pytest.mark.parametrize("B", [1, 17, 1024])
def test_transcript_kernel_simple_mul(dev, B):
    """simple_mul's 9 squeeze lengths at ragged B and the main path's,
    rows 1,275 bytes long (shorter than the staged blocks), the buffer 3
    bytes past an aligned address."""
    rng = np.random.default_rng(B)
    host = torch.from_numpy(rng.integers(0, 256, size=(B, 1275), dtype=np.uint8))
    buf = torch.empty(B * 1275 + 3, dtype=torch.uint8, device=dev)[3:].view(B, 1275)
    buf.copy_(host)
    got = cuda_blake.transcript_hashes(buf, SIMPLE_MUL_LENGTHS)
    want = cuda_blake.transcript_hashes_plain(buf, SIMPLE_MUL_LENGTHS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_transcript_kernel_lane_groups(dev):
    """B ragged against the rows a block the launcher derives (1, 2, 4 and
    8 on an H100's 132 SMs): the plain digests."""
    rng = np.random.default_rng(9)
    for B in (37, 133, 397, 1031):
        buf = torch.from_numpy(rng.integers(0, 256, size=(B, 1300), dtype=np.uint8)).to(dev)
        want = cuda_blake.transcript_hashes_plain(buf, SIMPLE_MUL_LENGTHS)
        got = cuda_blake.transcript_hashes(buf, SIMPLE_MUL_LENGTHS)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B


def _hashlib_digests(buf: np.ndarray, lengths):
    """(h1, h2) as the kernel's (B, S, 8) LE64 (lo, hi) words, by hashlib."""
    import hashlib

    def words(d):
        return np.frombuffer(d, "<u4").astype(np.int64)

    h1 = np.empty((buf.shape[0], len(lengths), 8), np.int64)
    h2 = np.empty_like(h1)
    for r, row in enumerate(buf):
        for i, n in enumerate(lengths):
            d = hashlib.blake2b(row[:n].tobytes(), digest_size=32).digest()
            h1[r, i], h2[r, i] = words(d), words(hashlib.blake2b(d, digest_size=32).digest())
    return h1, h2


@pytest.mark.parametrize("B,T", [(1024, 20_000), (1024, 40_000), (3, 300_000)])
def test_transcript_kernel_long(dev, B, T):
    """Long transcripts: at 20 KB the rows a block from B fit in shared
    memory, at 40 KB fewer rows a block do, at 300 KB not even one row's
    bytes do and every block is read from global memory."""
    rng = np.random.default_rng(T + B)
    buf = rng.integers(0, 256, size=(B, T), dtype=np.uint8)
    lengths = (1, 129, T // 2, T - 1, T)
    got = cuda_blake.transcript_hashes(torch.from_numpy(buf).to(dev), lengths)
    want = _hashlib_digests(buf, lengths)
    assert np.array_equal(got[0].cpu().numpy(), want[0]) and np.array_equal(got[1].cpu().numpy(), want[1])


@pytest.mark.parametrize("B", [1, 17, 1024])
def test_transcript_kernel_rounds(dev, B):
    """200 squeezes, more than a row's groups at 4 lanes (128 at one row a
    block): the squeezes take two rounds; unsorted lengths."""
    rng = np.random.default_rng(B + 200)
    buf = rng.integers(0, 256, size=(B, 1500), dtype=np.uint8)
    lengths = tuple(int(n) for n in rng.integers(1, 1501, size=200))
    got = cuda_blake.transcript_hashes(torch.from_numpy(buf).to(dev), lengths)
    want = _hashlib_digests(buf, lengths)
    assert np.array_equal(got[0].cpu().numpy(), want[0]) and np.array_equal(got[1].cpu().numpy(), want[1])


def _msm_rows(B, K, seed, dev):
    """(B, K) points drawn from K random G1 points and the identity, and
    random scalars with a zero and a q - 1 among them."""
    rng = np.random.default_rng(seed)
    n = min(K, 16)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=n)] + [None]
    tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host])).to(dev)
    pts = tab[torch.from_numpy(rng.integers(0, n + 1, size=(B, K))).to(dev)].contiguous()
    sc = _canon(FR_SPEC, (B, K), seed + 1, dev)
    sc[-1, K // 2] = torch.from_numpy(FR_SPEC.encode(FR_SPEC.N - 1)).to(dev)
    return pts, sc


@pytest.mark.parametrize("B,K", [(1, 1), (17, 8), (129, 17), (1024, 16), (256, 8), (17, 128),
                                 (1024, 3), (1024, 19), (1024, 32), (129, 36)])
def test_msm_kernel(dev, B, K):
    """Both window widths: the same limbs as the plain version of the
    kernel's decomposition (msm_windowed), and in affine coordinates the
    plain per-point MSM's; B ragged against the rows per block, K in whole
    and ragged chunks of points (128: 32 chunks); the multi-open shapes of
    the GWC19 flavor and the lookup and ATMS circuits (3, 17, 19, 32, 36:
    above 32, more than one point a lane)."""
    pts, sc = _msm_rows(B, K, B + K, dev)
    ref = tc.to_affine(cuda_curve.msm_plain(pts, sc))
    for wbits in (4, 5):
        got = cuda_curve.msm(pts, sc, wbits=wbits)
        assert torch.equal(got, tc.msm_windowed(pts, sc, wbits)), wbits
        for g, w in zip(tc.to_affine(got), ref):
            assert torch.equal(g, w)


@pytest.mark.parametrize("K", [9, 17, 37])
@pytest.mark.parametrize("mp", [2, 3, 4])
def test_shard_map_msm_on_the_card(dev, K, mp):
    """The point-sharded MSM (parallel/mesh.shard_map_msm) on a virtual
    mesh of mp entries of the card: the kernel on each padded slice, the
    partials summed by a point-add tree, equal in affine coordinates to the
    unsharded kernel's sum (which test_msm_kernel holds against the plain
    MSM)."""
    from plutus_halo2_tpu_torch.parallel import mesh as pm

    pts, sc = _msm_rows(129, K, 7 * K + mp, dev)
    before = cuda_curve.msm.launches
    got = pm.shard_map_msm(pts, sc, pm.make_mesh([dev] * mp, axis="mp"))
    assert cuda_curve.msm.launches - before == mp  # one kernel call a slice
    for g, w in zip(tc.to_affine(got), tc.to_affine(cuda_curve.msm(pts, sc))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("K", [1, 5, 33])
def test_msm_kernel_at_4_bit_windows(dev, K):
    """The stage probe's width (the Pallas kernel's wbits=4): 64 windows
    over a 9-entry table, against the plain MSM and the 5-bit kernel."""
    rng = np.random.default_rng(100 + K)
    host = [rc.g1_mul(rc.G1_GEN, int(s)) for s in rng.integers(1, 2**62, size=K)] + [None]
    tab = torch.from_numpy(np.stack([tc.host_point_to_mont(p) for p in host])).to(dev)
    B = 11
    pts = tab[torch.from_numpy(rng.integers(0, K + 1, size=(B, K))).to(dev)].contiguous()
    sc = _canon(FR_SPEC, (B, K), 16 + K, dev)
    sc[-1, 0] = torch.from_numpy(FR_SPEC.encode(FR_SPEC.N - 1)).to(dev)
    want = tc.to_affine(cuda_curve.msm_plain(pts, sc))
    for wbits in (4, 5):
        for g, w in zip(tc.to_affine(cuda_curve.msm(pts, sc, wbits=wbits)), want):
            assert torch.equal(g, w)


def test_msm_kernel_lane_groups(dev):
    """B ragged against the rows a block the launcher derives (1, 2, 4 and
    8 on an H100's 132 SMs): the plain version's limbs."""
    for B in (37, 133, 397, 1031):
        pts, sc = _msm_rows(B, 9, 5 + B, dev)
        assert torch.equal(cuda_curve.msm(pts, sc), tc.msm_windowed(pts, sc, 5)), B


def _probe_inputs(B, seed):
    rng = np.random.default_rng(seed)
    mat = torch.from_numpy(rng.integers(0, 127, (96, 48)).astype(np.int8))
    vec = torch.from_numpy(rng.integers(0, 127, (48, B)).astype(np.int8))
    return mat, vec


@pytest.mark.parametrize("B", [1, 17, 1000])
def test_mma_probe_kernels(dev, B):
    """The three tensor-core probe kernels at ragged batch widths against
    their plain versions, bit for bit, and the two chains against each
    other (int8 and bf16 products compute one integer function)."""
    mat, vec = _probe_inputs(B, B)
    m_d, v_d = mat.to(dev), vec.to(dev)
    assert torch.equal(cuda_mma.int8_dot(m_d, v_d).cpu(), cuda_mma.int8_dot_plain(mat, vec))
    want = cuda_mma.chain_plain(mat, vec)
    c8, c16 = cuda_mma.int8_chain(m_d, v_d).cpu(), cuda_mma.bf16_chain(m_d, v_d).cpu()
    assert torch.equal(c8, want) and torch.equal(c16, want)
    for steps in (0, 1, 7):
        short = cuda_mma.chain_plain(mat, vec, steps)
        assert torch.equal(cuda_mma.int8_chain(m_d, v_d, steps).cpu(), short)
        assert torch.equal(cuda_mma.bf16_chain(m_d, v_d, steps).cpu(), short)


@pytest.mark.parametrize("B", [1, 16, 17, 40, 1000, 2048])
def test_int8_chain_kernel(dev, B):
    """The int8 chain at ragged widths and several step counts, with a
    negative entry in each operand, bit for bit against the exact plain
    chain."""
    mat, vec = _probe_inputs(B, B + 2)
    mat[5, 7], vec[3, 0] = -100, -128
    m_d, v_d = mat.to(dev), vec.to(dev)
    for steps in (0, 1, 2, 7, 200):
        assert torch.equal(cuda_mma.int8_chain(m_d, v_d, steps).cpu(), cuda_mma.chain_plain(mat, vec, steps)), steps


@pytest.mark.parametrize("B", [16, 17, 2048])
def test_bf16_chain_kernel(dev, B):
    """The bf16 chain at a single warp's width, a ragged second warp and
    128 warps, bit for bit against the exact plain chain."""
    mat, vec = _probe_inputs(B, B + 1)
    want = cuda_mma.chain_plain(mat, vec)
    assert torch.equal(cuda_mma.bf16_chain(mat.to(dev), vec.to(dev)).cpu(), want)


@pytest.mark.parametrize("B", [1, 17, 64, 128, 129, 1024])
def test_pairing_kernel(dev, B):
    """Rows of e([r]G, [s]G2) e([t]G, G2): true where t = -r s (rows 0, 2
    mod 4), false otherwise, the identity on the left (r = 0) or the right
    (t = 0) in some rows, (O, O) in row 0; B ragged against the rows per
    block."""
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, S)), tp.prepare_g2(rc.G2_GEN))
    el, er, want = check_rows(B, B, dev)
    plain = cuda_pairing.pairing_check_plain(el, er, pp)
    assert torch.equal(plain, want)
    assert torch.equal(cuda_pairing.pairing_check(el, er, pp), plain)


def _artifacts():
    import os

    from plutus_halo2_tpu_torch.models.circuits import SimpleMulCircuit
    from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk
    from plutus_halo2_tpu_torch.utils.serialization import parse_public_inputs, vk_from_json

    art = os.path.join(os.path.dirname(__file__), "..", "examples", "artifacts")

    def read(name):
        with open(os.path.join(art, f"simple_mul_{name}")) as f:
            return f.read().strip()

    plan = plan_from_vk(SimpleMulCircuit(), vk_from_json(read("vk.json")))
    pis = parse_public_inputs(read("public_input.hex"))
    good = np.frombuffer(bytes.fromhex(read("proof.hex")), np.uint8)
    bad = np.frombuffer(bytes.fromhex(read("proof_invalid.hex")), np.uint8)
    return plan, pis, good, bad


@pytest.mark.parametrize("mode,hinted", [("off", False), ("aggregate", True), ("aggregate", False),
                                         ("exact", True)])
def test_verifier_on_gpu_matches_cpu(dev, mode, hinted):
    """The whole slice on the card (every stage through its kernel) against
    the same verifier on the CPU (every stage through its plain version), at
    a small ragged batch of the committed simple_mul artifacts, in each
    subgroup mode, with and without y-hints (one of them corrupted)."""
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier

    plan, pis, good, bad = _artifacts()
    batch = np.stack([good, bad, good, good, bad]).copy()
    batch[2, 100] ^= 0x40
    out = {}
    for d in (dev, torch.device("cpu")):
        v = TorchVerifier(plan, device=d, subgroup_check=mode)
        hints = None
        if hinted:
            hints = v.compute_y_hints(batch)
            hints[3, 4, 0] ^= 1
        w = v.subgroup_weights(torch.Generator().manual_seed(3))
        el, er, valid = v.core(batch, v.encode_public_inputs([pis] * len(batch)), hints, w)
        out[d.type] = (tc.to_affine(el), tc.to_affine(er), valid,
                       v.verify(batch, v.encode_public_inputs([pis] * len(batch)), hints,
                                torch.Generator().manual_seed(3)))
    g, c = out["cuda"], out["cpu"]
    assert torch.equal(g[2].cpu(), c[2])
    # pairing sides agree on rows whose points all decompressed: the complete
    # addition formulas assume the curve equation, so the kernel's and the
    # plain MSM's different addition chains part ways on off-curve points,
    # which those rows' verdicts already reject
    ok = c[2]
    assert ok.any()
    for a, b in zip(g[0] + g[1], c[0] + c[1]):
        assert torch.equal(a.cpu()[ok], b[ok])
    assert g[3].cpu().tolist() == c[3].tolist() == [True, False, False, not hinted, False]


def test_verify_rlc_on_gpu_matches_cpu(dev):
    """verify_rlc (group 4, the default mode with hints) on the card equals
    the CPU's verdicts, with failing groups re-checked in flight and, at a
    re-check width of 2, on the host."""
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier

    plan, pis, good, bad = _artifacts()
    batch = np.stack([good] * 8).copy()
    batch[2, 100] ^= 0x40
    batch[5] = bad
    want = [True, True, False, True, True, False, True, True]
    for recheck in (128, 2):
        got = {}
        for d in (dev, torch.device("cpu")):
            v = TorchVerifier(plan, device=d)
            v._RLC_RECHECK = recheck
            got[d.type] = v.verify_rlc(batch, v.encode_public_inputs([pis] * 8),
                                       v.compute_y_hints(batch), group=4,
                                       generator=torch.Generator().manual_seed(9)).tolist()
        assert got["cuda"] == got["cpu"] == want


@pytest.mark.parametrize("B", [1, 17, 128])
def test_graph_form_equals_eager_form(dev, B):
    """verify() (the default mode, one corrupted hint) and
    verify_rlc_device (group 1 at B = 1 and 17, 8 at 128) as captured
    programs against the eager form on the same inputs and weights, on the
    key's first call (the warm-up) and on replays over alternating batches,
    with the launch counts of one run added on every replay."""
    from plutus_halo2_tpu_torch.models.programs import COUNTED
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier

    plan, pis, good, bad = _artifacts()
    mixed = np.stack([good] * B).copy()
    mixed[B // 2] = bad
    mixed[0, 100] ^= 0x40
    honest = np.stack([good] * B)
    graph, eager = TorchVerifier(plan, device=dev), TorchVerifier(plan, device=dev, graphs=False)
    pis_b = graph.encode_public_inputs([pis] * B)
    group = 8 if B % 8 == 0 else 1
    w = graph.rlc_weights(B, torch.Generator().manual_seed(4))
    for batch in (mixed, honest, mixed):
        hints = graph.compute_y_hints(batch)
        hints[-1, 1, 0] ^= 1
        out = {}
        for name, v in (("graph", graph), ("eager", eager)):
            before = [f.launches for f in COUNTED]
            ok = v.verify(batch, pis_b, hints, torch.Generator().manual_seed(3)).cpu()
            rlc = v.verify_rlc_device(batch, pis_b, w, hints, group=group,
                                      generator=torch.Generator().manual_seed(3))
            out[name] = (ok.tolist(), rlc[0].cpu().tolist(), int(rlc[1]), v.msm_term_counts,
                         [f.launches - b for f, b in zip(COUNTED, before)])
        assert out["graph"] == out["eager"]
        want = [bool((batch[i] == good).all()) and i != B - 1 for i in range(B)]
        assert out["graph"][0] == out["graph"][1] == want
    assert (graph.programs.captures, graph.programs.replays) == (2, 4)
    assert eager.programs.captures == 0


def test_back_to_back_replays_keep_distinct_outputs(dev):
    """Two replays of one program issued before any sync: each call's
    verdicts are its own batch's (the outputs are clones, and a host input's
    pinned staging buffer is not overwritten while its copy is queued)."""
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier

    plan, pis, good, bad = _artifacts()
    B = 64
    honest = np.stack([good] * B)
    mixed = honest.copy()
    mixed[::3] = bad
    v = TorchVerifier(plan, device=dev, subgroup_check="off")
    pis_b = v.encode_public_inputs([pis] * B)
    v.verify(honest, pis_b)  # the capture
    torch.cuda.synchronize()
    outs = [v.verify(b, pis_b) for b in (mixed, honest, mixed, honest)]
    torch.cuda.synchronize()
    want_mixed = [i % 3 != 0 for i in range(B)]
    assert [o.cpu().tolist() for o in outs] == [want_mixed, [True] * B] * 2
    outs = [v.verify(torch.from_numpy(b).to(dev), torch.from_numpy(pis_b).to(dev)) for b in (mixed, honest)]
    assert [o.cpu().tolist() for o in outs] == [want_mixed, [True] * B]


@pytest.mark.parametrize("B", [1, 17, 129])
def test_pairing_kernel_enable_flag(dev, B):
    """The pairing kernel gated by a device flag: at 1 its verdicts, at 0
    every row true, both against the plain version's torch.where, at B
    ragged against the rows per block."""
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, S)), tp.prepare_g2(rc.G2_GEN))
    el, er, want = check_rows(B, B + 3, dev)
    for flag in (True, False):
        for enable in (torch.tensor(flag, device=dev), torch.tensor([int(flag)], dtype=torch.int32, device=dev)):
            got = cuda_pairing.pairing_check(el, er, pp, enable=enable)
            plain = cuda_pairing.pairing_check_plain(el, er, pp, enable=enable)
            assert torch.equal(got, plain)
            assert got.tolist() == (want.tolist() if flag else [True] * B)


def _nonsubgroup_point():
    x = 100
    while True:
        rhs = (x**3 + 4) % FP_SPEC.N
        y = pow(rhs, (FP_SPEC.N + 1) >> 2, FP_SPEC.N)
        if y * y % FP_SPEC.N == rhs and not rc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def _encoding_pool():
    """(encoding, hint, kind) per crafted point: kind "g" an honest G1 point,
    "o" the identity, "e" a non-subgroup E(Fp) point, "x" invalid."""
    P = FP_SPEC.N
    pool = []
    for k in (3, 5, 7, 11):
        p = rc.g1_mul(rc.G1_GEN, k)
        pool.append((rc.g1_compress(p), min(p[1], P - p[1]), "g"))
        pool.append((rc.g1_compress(p), max(p[1], P - p[1]), "g"))
    pool.append((bytes([0xC0] + [0] * 47), 0, "o"))
    e = _nonsubgroup_point()
    pool.append((rc.g1_compress(e), e[1], "e"))
    pool.append((bytes([0xC0, 1] + [0] * 46), 0, "x"))  # bad infinity
    xbig = (P + 2).to_bytes(48, "big")
    pool.append((bytes([xbig[0] | 0x80]) + xbig[1:], 3, "x"))  # x >= p
    x1 = (1).to_bytes(48, "big")
    pool.append((bytes([x1[0] | 0x80]) + x1[1:], 12345, "x"))  # non-square x
    p = rc.g1_mul(rc.G1_GEN, 13)
    pool.append((bytes([rc.g1_compress(p)[0] & 0x7F]) + rc.g1_compress(p)[1:], p[1], "x"))
    pool.append((rc.g1_compress(p), p[1] + 1, "x"))  # wrong hint
    pool.append((rc.g1_compress(p), p[1] + (7 << 384), "g"))  # oversized hint: read mod 2^384
    pool.append((rc.g1_compress(p), p[1] + 1 + (7 << 384), "x"))
    return pool


def _grid(B, K, seed, kinds):
    """A (B, K) grid: row b draws its points from the pool entries of kinds
    kinds[b % len(kinds)]."""
    pool = _encoding_pool()
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, K, 48), np.uint8)
    hints = np.zeros((B, K, FP_SPEC.L), np.int64)
    row_kinds = []
    for b in range(B):
        allowed = [i for i, (_e, _h, k) in enumerate(pool) if k in kinds[b % len(kinds)]]
        pick = rng.choice(allowed, size=K)
        row_kinds.append([pool[i][2] for i in pick])
        for k, i in enumerate(pick):
            raw[b, k] = np.frombuffer(pool[i][0], np.uint8)
            h = pool[i][1]
            hints[b, k] = [(h >> (16 * j)) & 0xFFFF for j in range(FP_SPEC.L)]
    return raw, hints, row_kinds


@pytest.mark.parametrize("B,K", [(1, 1), (37, 4), (130, 10), (37, 33), (17, 128), (1024, 10),
                                 (1024, 11), (37, 15), (1024, 18)])
@pytest.mark.parametrize("rounds", [None, 1, 2, 3, 4])
def test_decompress_kernel(dev, B, K, rounds):
    raw, hints, kinds = _grid(B, K, 100 * B + K, ["go", "goe", "gox", "goex"])
    raw_t, hints_t = torch.from_numpy(raw).to(dev), torch.from_numpy(hints).to(dev)
    w = None if rounds is None else torch.randint(1, 1 << 16, (rounds, K),
                                                   generator=torch.Generator().manual_seed(K))
    got = cuda_curve.decompress_hinted(raw_t, hints_t, w)
    want = cuda_curve.decompress_hinted_plain(raw_t, hints_t, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].cpu().tolist() == [[k != "x" for k in row] for row in kinds]
    if rounds is not None:
        all_valid = got[1].all(-1)
        assert torch.equal(got[2][all_valid], want[2][all_valid])
        assert torch.equal(got[2] & all_valid, want[2] & all_valid)
        member = torch.tensor(["e" not in row for row in kinds], device=dev)
        assert torch.equal(got[2][all_valid], member[all_valid])
        old = tc.aggregate_subgroup_check(want[0], w)  # the second reference
        assert torch.equal(got[2][all_valid], old[all_valid])


def test_decompress_kernel_lane_groups(dev):
    """The fused kernel at B ragged against the rows a block its launcher
    derives (1, 2, 4 and up to 16 on an H100's 132 SMs): the plain version's
    points and flags, and its verdicts on the rows whose points all
    decode."""
    w = torch.randint(1, 1 << 16, (2, 10), generator=torch.Generator().manual_seed(2))
    for B in (37, 133, 397, 2000):
        raw, hints, _kinds = _grid(B, 10, 3 + B, ["go", "goe", "gox"])
        raw_t, hints_t = torch.from_numpy(raw).to(dev), torch.from_numpy(hints).to(dev)
        got = cuda_curve.decompress_hinted(raw_t, hints_t, w)
        want = cuda_curve.decompress_hinted_plain(raw_t, hints_t, w)
        all_valid = got[1].all(-1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), B
        assert torch.equal(got[2] & all_valid, want[2] & all_valid), B


def _hintless_grid(B, K, seed):
    """(raw, decodes) of a (B, K) grid for decoding without hints: the
    encodings of _encoding_pool (honest points, the identity, a point
    outside G1, a bad infinity, x >= p, a non-square x, a cleared
    compression bit), the honest points' negations (the other sign) and
    infinity with the sign set, each marked by the spec's decoder."""
    encs = list(dict.fromkeys(e for e, _h, _k in _encoding_pool()))
    encs += [rc.g1_compress(rc.g1_neg(rc.g1_mul(rc.G1_GEN, k))) for k in (3, 5, 7, 11)]
    encs.append(bytes([0xE0] + [0] * 47))

    def decodes(enc):
        try:
            rc.g1_decompress(enc)
            return True
        except ValueError:
            return False

    pick = np.random.default_rng(seed).integers(0, len(encs), size=(B, K))
    raw = np.stack([np.frombuffer(e, np.uint8) for e in encs])[pick]
    return raw, np.array([decodes(e) for e in encs])[pick]


@pytest.mark.parametrize("B,K", [(1024, 10), (1, 1), (37, 3), (133, 11)])
def test_sqrt_decode_kernel(dev, B, K):
    """The hintless decompress kernel at the main path's shape and at point
    counts ragged against the points a block its launcher fixes: points and
    valid flags bit for bit against the plain version, the flags against
    the spec's decoder, one launch a call."""
    raw, decodes = _hintless_grid(B, K, 7 * B + K)
    raw_t = torch.from_numpy(raw).to(dev)
    before = cuda_curve.decompress_hintless.launches
    got = cuda_curve.decompress_hintless(raw_t)
    assert cuda_curve.decompress_hintless.launches == before + 1
    want = tc.decompress(raw_t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].cpu().numpy().tolist() == decodes.tolist()


def _subgroup_rows(B, K, seed, dev):
    """(B, K) decoded points of honest rows, rows of identities and rows
    with a point outside G1, each point as another projective
    representative (sX : sY : sZ); and each row's membership."""
    raw, hints, kinds = _grid(B, K, seed, ["go", "goe", "o", "e"])
    pts, valid = cuda_curve.decompress_hinted_plain(torch.from_numpy(raw), torch.from_numpy(hints))
    assert bool(valid.all())
    s = torch.from_numpy(FP_SPEC.to_mont(0xC0FFEE))
    return tc.fp.mul(pts, s).to(dev).contiguous(), ["e" not in row for row in kinds]


@pytest.mark.parametrize("B,K", [(1, 1), (37, 4), (130, 10), (37, 33), (1024, 10), (17, 128)])
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
def test_subgroup_kernel(dev, B, K, rounds):
    """Against the plain version of the kernel's decomposition and the JAX
    package's algorithm (the CPU route), and the rows' construction."""
    pts, member = _subgroup_rows(B, K, 7 * B + K, dev)
    w = torch.randint(1, 1 << 16, (rounds, K), generator=torch.Generator().manual_seed(B))
    got = cuda_curve.aggregate_subgroup_check(pts, w)
    assert torch.equal(got, tc.aggregate_subgroup_check_windowed(pts, w))
    assert torch.equal(got, cuda_curve.aggregate_subgroup_check_plain(pts, w))
    assert got.cpu().tolist() == member


def test_subgroup_kernel_lane_groups(dev):
    """B ragged against the rows a block the launcher derives (1, 2, 4 and
    up to 16 on an H100's 132 SMs): the plain version's verdicts and the rows'
    construction."""
    w = torch.randint(1, 1 << 16, (2, 10), generator=torch.Generator().manual_seed(2))
    for B in (37, 133, 397, 2000):
        pts, member = _subgroup_rows(B, 10, 3 + B, dev)
        got = cuda_curve.aggregate_subgroup_check(pts, w)
        assert torch.equal(got, tc.aggregate_subgroup_check_windowed(pts, w)), B
        assert got.cpu().tolist() == member, B


def test_kernel_waits_for_queued_torch_work(dev):
    """A kernel launched right behind queued torch work on its input sees
    that work done: the wrappers launch on torch's current stream."""
    a, b = _canon(FP_SPEC, (1 << 14,), 8, dev), _canon(FP_SPEC, (1 << 14,), 9, dev)
    want = cuda_field.mont_mul_plain(a, b, FP_SPEC)
    big = torch.randn(4096, 4096, device=dev)
    for _ in range(3):
        x = torch.zeros_like(a)
        torch.cuda.synchronize()
        for _ in range(4):
            big = big @ big / 64.0  # queued device work ahead of the copy
        x.copy_(a)
        assert torch.equal(cuda_field.fp_mont_mul(x, b), want)


_FIRST_LAUNCH = """
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
from plutus_halo2_tpu_torch.ops import cuda_field
from plutus_halo2_tpu_torch.ops.limb import FP_SPEC, FR_SPEC
rng = np.random.default_rng(int(sys.argv[2]))
bad = []
for spec, kern in ((FP_SPEC, cuda_field.fp_mont_mul), (FR_SPEC, cuda_field.fr_mont_mul)):
    ab = []
    for _ in range(2):
        v = [int.from_bytes(r.tobytes(), "little") % spec.N
             for r in rng.integers(0, 256, size=(4096, 2 * spec.L), dtype=np.uint8)]
        ab.append(torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(spec.L)] for x in v]).cuda())
    got, want = kern(*ab), cuda_field.mont_mul_plain(*ab, spec)
    torch.cuda.synchronize()
    bad.append(int((got != want).any(-1).sum()))
print(bad)
"""


def test_first_launch_in_fresh_processes(dev):
    """The first kernel launches of a fresh process (library load, module
    load, first use of the constants) are exact, in a few new processes."""
    import os
    import subprocess
    import sys

    from plutus_halo2_tpu_torch.ops import _build

    _build.library()  # build once, before the subprocesses load it
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    for seed in range(4):
        out = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH, root, str(seed)],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "[0, 0]"


def _fr_words(n, seed, dev):
    """(n, 8) canonical words: 0, 1 and q - 1 first, then random values."""
    from plutus_halo2_tpu_torch.refimpl.field import Q

    rng = np.random.default_rng(seed)
    vals = [0, 1, Q - 1] + [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(max(n - 3, 0))]
    return tpoly.to_words(vals[:n], dev)


@pytest.mark.parametrize("lg", [0, 1, 2, 3, 7, 10, 13, 17])
def test_poly_ntt_kernel(dev, lg):
    """fr_ntt against the plain NTT at 2^lg points, and the inverse
    transform of its omega^-1 call, scaled by n^-1, gives the input back."""
    from plutus_halo2_tpu_torch.refimpl.field import fr_inv
    from plutus_halo2_tpu_torch.refimpl.poly import domain_omega

    n, w = 1 << lg, domain_omega(lg)
    a = _fr_words(n, lg, dev)
    got = cuda_poly.fr_ntt(a, w)
    assert torch.equal(got, tpoly.ntt_plain(a.cpu(), w).to(dev))
    back = cuda_poly.fr_scale_array(cuda_poly.fr_ntt(got, fr_inv(w)), fr_inv(n))
    assert torch.equal(back, a)


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000, 4097])
def test_poly_elementwise_kernels(dev, n):
    """fr_mul_array, fr_scale_array and fr_powers_mul_array against their
    plain versions at ragged lengths (the powers past one table of each
    half), k = 0, 1, q - 1 and a random k."""
    from plutus_halo2_tpu_torch.refimpl.field import Q

    a, b = _fr_words(n, 1, dev), _fr_words(n, 2, dev).flip(0).contiguous()
    assert torch.equal(cuda_poly.fr_mul_array(a, b), tpoly.mul_array_plain(a.cpu(), b.cpu()).to(dev))
    for k in (0, 1, Q - 1, 0x1234567890ABCDEF1234567890ABCDEF % Q):
        assert torch.equal(cuda_poly.fr_scale_array(a, k), tpoly.scale_array_plain(a.cpu(), k).to(dev))
        assert torch.equal(cuda_poly.fr_powers_mul_array(a, k), tpoly.powers_mul_array_plain(a.cpu(), k).to(dev))


def test_poly_kernels_count_and_refuse(dev):
    """Each wrapper counts its launches; a wrong shape or dtype raises."""
    a = _fr_words(256, 3, dev)
    before = (cuda_poly.fr_ntt.launches, cuda_poly.fr_mul_array.launches, cuda_poly.fr_scale_array.launches,
              cuda_poly.fr_powers_mul_array.launches)
    cuda_poly.fr_ntt(a, 1)
    cuda_poly.fr_mul_array(a, a)
    cuda_poly.fr_scale_array(a, 3)
    cuda_poly.fr_powers_mul_array(a, 3)
    after = (cuda_poly.fr_ntt.launches, cuda_poly.fr_mul_array.launches, cuda_poly.fr_scale_array.launches,
             cuda_poly.fr_powers_mul_array.launches)
    assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 1]
    with pytest.raises(ValueError):
        cuda_poly.fr_ntt(a[:255].contiguous(), 1)
    with pytest.raises(ValueError):
        cuda_poly.fr_mul_array(a, a.to(torch.int64))
