"""Gate-equation expected values through the port's scalar environment:
the counterpart of tests/test_gate_equations.py. The same vectors
(examples/equations_test.build_plans(include_atms=False): simple_mul,
lookup_table, mul_chain; lookup_table has no custom gate) and the committed
examples/artifacts/gates_test_vectors.json: every gate polynomial of each
plan, evaluated by the port's eval_expr over Montgomery Fr limb tensors
(models/verifier_torch._FrEnv) at the committed leaf values, must give
the committed expected value bit for bit."""

import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from plutus_halo2_tpu_torch.models.plan import eval_expr  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import _FrEnv  # noqa: E402
from plutus_halo2_tpu_torch.ops.limb import FR_SPEC  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
VECTORS = os.path.join(ROOT, "examples", "artifacts", "gates_test_vectors.json")


def _plans():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from equations_test import build_plans

    return build_plans(include_atms=False)


def test_gate_equations_torch_bit_exact():
    with open(VECTORS) as f:
        committed = {v["circuit"]: v for v in json.load(f)}
    plans = _plans()
    assert [name for name, _plan in plans] == ["simple_mul", "lookup_table", "mul_chain"]
    checked = 0
    for name, plan in plans:
        vec = committed[name]

        def leaves(key):
            return [torch.from_numpy(FR_SPEC.to_mont(int(h, 16))) for h in vec[key]]

        env = _FrEnv("cpu", vars_={}, advice_evals=leaves("advice_evals"), fixed_evals=leaves("fixed_evals"),
                     perm_common_evals=[], perm_z_evals=[], lookup_evals=[])
        assert len(plan.gates) == len(vec["gate_values"])  # lookup_table has no custom gate
        for gi, gate in enumerate(plan.gates):
            got = FR_SPEC.from_mont_int(eval_expr(gate, env).numpy())
            want = int(vec["gate_values"][gi], 16)
            assert got == want, f"{name} gate {gi}: {got:#x} != {want:#x}"
            checked += 1
    assert checked == 2
