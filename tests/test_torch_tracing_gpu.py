"""The recorder (``utils/tracing.py``) on the card, in the graph form users
run: a program captured with tracing on gives the verdicts of one captured
with it off, on the key's first call and on replays, for ``verify()`` and
``verify_rlc_device()``; it has the untraced graph's kernel nodes plus one
event-record node a stage mark (the untraced one none); every replay's
stage events complete, the top-level stages add up to within 1 % of its
graph's span, and its mapped device events fall inside its host span
within the clock's uncertainty (at most 50 us); and two calls in flight
each time their own replay. Imports no JAX; run with ``python -m pytest
tests/test_torch_tracing_gpu.py -m gpu --noconftest`` on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.utils import tracing  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set  # noqa: E402

pytestmark = pytest.mark.gpu
B = 64


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph form has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    tracing.RECORDER.clear()
    yield tracing.RECORDER
    tracing.disable()
    tracing.RECORDER.clear()


@pytest.fixture(scope="module")
def inputs(dev):
    plan, proof, bad, pis = load_set("simple_mul")
    good = np.frombuffer(proof, np.uint8)
    batch = np.stack([good] * B)
    batch[5] = np.frombuffer(bad, np.uint8)
    batch[9, 100] ^= 0x40
    v = TorchVerifier(plan, device=dev)
    hints = v.compute_y_hints(batch)
    hints[B - 1, 1, 0] ^= 1
    return v, batch, v.encode_public_inputs([pis] * B), hints


def _calls(v, batch, pis, hints, n=3):
    out = []
    for k in range(n):
        gen = torch.Generator().manual_seed(7 + k)
        ok = v.verify(batch, pis, hints, gen)
        rlc = v.verify_rlc_device(batch, pis, v.rlc_weights(B, gen), hints, group=8, generator=gen)
        out.append((ok.cpu().tolist(), rlc[0].cpu().tolist(), int(rlc[1])))
    return out


def test_traced_graph_equals_untraced(dev, recorder, inputs):
    v, batch, pis, hints = inputs
    untraced = _calls(v, batch, pis, hints)
    tracing.enable()
    traced = _calls(v, batch, pis, hints)
    tracing.disable()
    assert traced == untraced
    want = [i not in (5, 9, B - 1) for i in range(B)]
    assert all(ok == rlc == want for ok, rlc, _n in traced)
    progs = v.programs.cache
    for key, prog in progs.items():
        if key[-1] == "traced":
            twin = progs[key[:-1]]
            assert prog.nodes["kernel"] == twin.nodes["kernel"] > 300
            assert twin.nodes["event"] == 0 and prog.nodes["event"] == len(prog.mark_nodes) >= 8
    calls = tracing.calls()
    assert [c.captured for c in calls] == [True, True] + [False] * 4
    unc = tracing.RECORDER.clock()[dev.index or 0]["uncertainty_s"]
    assert unc <= 50e-6
    for c in calls[2:]:
        assert c.stages and all(s.ms > 0 for s in c.stages if s.name not in ("post", "recheck", "final"))
        assert abs(c.top_ms() - c.graph_ms) <= 0.01 * c.graph_ms
        assert c.device["call_start"] >= c.spans[0].start - unc
        assert c.device["call_start"] <= c.device["graph_start"] <= c.device["graph_end"] <= c.device["call_end"]
        top = [s for s in c.stages if s.parent is None]
        assert top[0].start >= c.device["graph_start"] - unc and top[-1].end <= c.device["graph_end"] + unc
        names = [s.name for s in top]
        assert names[:4] == ["transcript", "decompress", "fr_side", "multiopen"]
        assert names[4:] == (["pairing"] if c.entry == "verify" else ["rlc_msm", "pairing", "post", "recheck",
                                                                         "final"])


def test_two_calls_in_flight_time_their_own_replays(dev, recorder, inputs):
    v, batch, pis, hints = inputs
    tracing.enable()
    _calls(v, batch, pis, hints, n=1)  # the traced keys' captures
    recorder.clear()
    other = batch.copy()
    other[20] = other[5]
    gen = torch.Generator().manual_seed(11)
    first = v.verify(batch, pis, hints, gen)
    second = v.verify(other, pis, hints, gen)  # issued before the first one's verdicts are read
    a, b = tracing.calls()
    assert not first.cpu()[5] and not second.cpu()[20]
    unc = tracing.RECORDER.clock()[dev.index or 0]["uncertainty_s"]
    assert a.device["graph_end"] <= b.device["graph_start"] + unc
    for c in (a, b):
        assert all(c.device["graph_start"] - unc <= s.start <= s.end <= c.device["graph_end"] + unc
                   for s in c.stages)
        assert abs(c.top_ms() - c.graph_ms) <= 0.01 * c.graph_ms
