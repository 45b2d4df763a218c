"""The traffic generator: the same seed gives the same inputs, invalid rows
land where the layout says, in the stated mix of kinds, and the inputs are
in the port's formats (y-hints and public inputs as the port makes them)."""

import numpy as np
import pytest

from portbench import spec, traffic

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 977


def _gen(name, seed, **over):
    cell = spec.cell(name, False)
    cell.traffic.update(over)
    return cell, traffic.generate(cell.config, cell.circuit(), cell.traffic, seed, cell.artifacts)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    _c, a = _gen(name, SEED, batch=64, layouts=4)
    _c, b = _gen(name, SEED, batch=64, layouts=4)
    _c, other = _gen(name, SEED + 1, batch=64, layouts=4)
    assert a.distinct == b.distinct and a.kinds == b.kinds
    for x, y in zip(a.layouts, b.layouts):
        assert np.array_equal(x.rows, y.rows) and np.array_equal(x.proofs, y.proofs)
        for u, v in ((x.hints, y.hints), (x.rlc_weights, y.rlc_weights)):
            assert (u is None and v is None) or np.array_equal(u, v)
    assert a.distinct != other.distinct or any(not np.array_equal(x.rows, y.rows)
                                               for x, y in zip(a.layouts, other.layouts))


@pytest.mark.parametrize("name", CELLS)
def test_invalid_rows_land_where_the_layout_says(name):
    cell, g = _gen(name, SEED)
    t = cell.traffic
    kinds = t["invalid_kinds"]
    assert g.kinds[0] == "honest" and len(set(g.distinct)) == len(g.distinct)
    per_kind = {k: sum(1 for x in g.kinds if x == k) for k in kinds}
    assert all(n == (1 if k == "invalid_twin" else t["variants_per_kind"]) for k, n in per_kind.items())
    honest = np.frombuffer(g.distinct[0], np.uint8)
    for li, lay in enumerate(g.layouts):
        assert lay.proofs.shape == (t["batch"], len(g.distinct[0]))
        bad = np.nonzero(lay.rows)[0]
        assert len(bad) == t["invalid_per_batch"]
        assert all((lay.proofs[i] == honest).all() for i in range(t["batch"]) if lay.rows[i] == 0)
        for i in bad:
            assert lay.proofs[i].tobytes() == g.distinct[lay.rows[i]] != g.distinct[0]
        got = sorted(g.kinds[lay.rows[i]] for i in bad)
        n = t["invalid_per_batch"]
        assert got == sorted(kinds[(li * n + j) % len(kinds)] for j in range(n))


def test_variant_kinds_change_what_they_say():
    _c, g = _gen("simple_mul.rlc8.b1024", SEED)
    honest = g.distinct[0]
    for v, kind in zip(g.distinct[1:], g.kinds[1:]):
        diff = [i for i in range(len(honest)) if honest[i] != v[i]]
        if kind in ("point_bit", "scalar_bit"):
            assert len(diff) == 1 and bin(honest[diff[0]] ^ v[diff[0]]).count("1") == 1
        elif kind == "noncanonical_scalar":
            off = diff[0] - diff[0] % 1  # the scalar's bytes changed, read as s + q
            items = dict(traffic.proof_items(g.plan))
            start = max(o for o in items if o <= diff[0])
            assert items[start] == "scalar" and all(start <= i < start + 32 for i in diff) and off >= start
            s = int.from_bytes(honest[start:start + 32], "little")
            assert int.from_bytes(v[start:start + 32], "little") == s + traffic.Q


@pytest.mark.parametrize("name", ["simple_mul.rlc8.b1024", "atms_with_lookups_50_90.exact.b64"])
def test_inputs_in_the_port_formats(name):
    import torch

    from portbench import program

    cell, g = _gen(name, SEED, batch=16, layouts=2, invalid_per_batch=2)
    v = program.verifier(cell.config, cell.traffic, g.vk_json, "cpu")
    assert np.array_equal(g.pis, v.encode_public_inputs([g.public_inputs] * 16))
    for lay in g.layouts:
        assert np.array_equal(lay.hints, v.compute_y_hints(lay.proofs))
    assert all(isinstance(b.proofs, torch.Tensor) for b in program.batches(g))
