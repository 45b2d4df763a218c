"""Gate-equation vector generator — the port's counterpart of
``examples/equations_test.py`` and of the reference's
`cargo run --example equations_test` (examples/equations_test.rs:50-57),
which renders `gates_test.hbs` into a standalone Aiken expected-value unit
test for every gate polynomial of the circuit.

For each circuit it derives deterministic pseudo-random evaluations for
every advice/fixed query leaf, evaluates each gate expression with the
pure-Python spec environment, and writes the vectors as the JSON of the
committed ``examples/artifacts/gates_test_vectors.json``
(``tests/test_torch_gate_equations.py`` replays them through the port's
limb expression evaluator). The circuits' keygen runs on the card unless
``--cpu`` asks for the plain versions.

Usage: python3 -m plutus_halo2_tpu_torch.examples.equations_test [--atms] [--cpu] [--out DIR]
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

from ..models.plan import FLAVOR_HALO2, eval_expr
from ..refimpl.field import Q
from ._common import device_of, parser


def det_scalar(tag: str) -> int:
    """Deterministic field element from a tag (blake2b, like the transcript)."""
    return int.from_bytes(hashlib.blake2b(tag.encode(), digest_size=32).digest(), "little") % Q


def gate_vectors(name: str, plan) -> dict:
    """Evaluate every gate expression of a plan at deterministic leaf values."""
    from ..refimpl.verifier import _ScalarEnv

    advice = [det_scalar(f"{name}:advice:{i}") for i in range(len(plan.advice_queries))]
    fixed = [det_scalar(f"{name}:fixed:{i}") for i in range(len(plan.fixed_queries))]
    env = _ScalarEnv(
        vars_={},
        advice_evals=advice,
        fixed_evals=fixed,
        instance_evals=[],
        perm_common_evals=[],
        perm_z_evals=[],
        lookup_evals=[],
    )
    expected = [hex(eval_expr(g, env)) for g in plan.gates]
    return {
        "circuit": name,
        "advice_evals": [hex(v) for v in advice],
        "fixed_evals": [hex(v) for v in fixed],
        "gate_values": expected,
    }


def build_plans(include_atms: bool, device=None):
    from ..models.circuits import LookupRangeCircuit, MulChainCircuit, SimpleMulCircuit
    from ..refimpl.keygen import keygen
    from ..refimpl.srs import TrapdoorSRS

    srs = TrapdoorSRS.from_seed(b"equations-test")
    circuits = [("simple_mul", SimpleMulCircuit()), ("lookup_table", LookupRangeCircuit()),
                ("mul_chain", MulChainCircuit(length=16))]
    if include_atms:
        # the ATMS example's default party data (examples/equations_test.py
        # builds AtmsCircuit() without any, which its constructor refuses)
        from ..models.atms import AtmsCircuit, prepare_test_signatures
        from .atms import MSG

        pks, sigs, _comm = prepare_test_signatures(2, 1, MSG)
        circuits.append(("atms", AtmsCircuit(pks, sigs, MSG, 1)))
    return [(name, keygen(circuit, flavor=FLAVOR_HALO2, srs=srs, device=device)[1]) for name, circuit in circuits]


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--atms", action="store_true", help="add the ATMS circuit")
    args = ap.parse_args(argv)
    vectors = [gate_vectors(name, plan) for name, plan in build_plans(args.atms, device_of(args))]
    os.makedirs(args.out, exist_ok=True)
    out_path = Path(args.out) / "gates_test_vectors.json"
    with open(out_path, "w") as f:
        json.dump(vectors, f, indent=1)
    for v in vectors:
        print(f"{v['circuit']}: {len(v['gate_values'])} gate equations")
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
