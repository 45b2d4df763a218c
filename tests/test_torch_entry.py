"""The port's entry points (plutus_halo2_tpu_torch/entry.py, the
counterpart of __graft_entry__.py) on the CPU, every kernel through its
plain version; verdicts exactly, against the port's spec verifier
(refimpl/verifier.py) on the same rows:

- entry(device="cpu") returns the default hintless verify (aggregate
  subgroup test, 1 round, fixed weights) with batch-4 arguments, and the
  module's command (main(["--cpu"])) prints its verdicts, the spec's;
- dryrun_multichip(4, device="cpu") runs all three legs at the default
  budget, none skipped: DP with one corrupted row, dp 2 x mp 2, and
  atms_with_lookups (K = 36) through the DP mesh;
- with no budget left, legs 2 and 3 print explicit "SKIPPED (budget)"
  lines and leg 1 still runs."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch import entry as ent  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.verifier import verify  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set  # noqa: E402


@functools.lru_cache(maxsize=None)
def _spec(name, flipped):
    """The spec's verdict on the set's honest proof, bit-flipped at byte 100
    when `flipped`."""
    plan, proof, _bad, pis = load_set(name)
    row = bytearray(proof)
    if flipped:
        row[100] ^= 0x40
    return verify(plan, bytes(row), pis)[0]


def test_entry_is_the_hintless_default_verify():
    fn, args = ent.entry(device="cpu")
    v = fn.__self__
    assert fn.__func__ is type(v).verify and v.device.type == "cpu"
    assert (v.subgroup_check, v.subgroup_rounds) == ("aggregate", 1)
    proofs, pis, hints, gen, sw = args
    assert proofs.shape == (4, v.layout.proof_len) and pis.shape == (4, v.n_pi, 17)
    assert hints is None and gen is None
    assert torch.equal(sw, v.subgroup_weights(torch.Generator().manual_seed(0)))


def test_entry_command_prints_the_specs_verdicts(capsys):
    verdicts = ent.main(["--cpu"])
    assert verdicts.tolist() == [_spec("simple_mul", False)] * 4 == [True] * 4
    assert "entry verdicts: [ True  True  True  True]" in capsys.readouterr().out


def test_dryrun_multichip_runs_all_three_legs(capsys, monkeypatch):
    monkeypatch.delenv("PH2_DRYRUN_BUDGET_S", raising=False)
    out = ent.dryrun_multichip(4, device="cpu")
    want = [_spec("simple_mul", i == 3) for i in range(8)]
    assert want == [i != 3 for i in range(8)]
    assert out == {"dp": want, "dp_x_mp": want,
                   "atms_with_lookups": [_spec("atms_with_lookups", i == 1) for i in range(4)]}
    assert out["atms_with_lookups"] == [True, False, True, True]
    lines = capsys.readouterr().out.splitlines()
    assert "SKIPPED" not in "\n".join(lines)
    assert [line.split(":")[0] for line in lines] == [
        "dryrun_multichip(4) DP leg", "dryrun_multichip(4) dp x mp sharded-MSM leg (4 devices)",
        "dryrun_multichip(4) atms_with_lookups DP leg"]


def test_dryrun_multichip_skips_by_budget_out_loud(capsys, monkeypatch):
    monkeypatch.setenv("PH2_DRYRUN_BUDGET_S", "0")
    out = ent.dryrun_multichip(2, device="cpu")
    assert out == {"dp": [True, True, True, False], "dp_x_mp": "SKIPPED", "atms_with_lookups": "SKIPPED"}
    text = capsys.readouterr().out
    assert "dp x mp leg: SKIPPED (budget" in text and "atms_with_lookups DP leg: SKIPPED (budget" in text


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ent.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        ent.dryrun_multichip(2)
    assert np.asarray(ent._mesh_devices(3, "cpu")).tolist() == [torch.device("cpu")] * 3
