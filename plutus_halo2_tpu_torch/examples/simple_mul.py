"""simple_mul example — the port's counterpart of
``examples/simple_mul.py`` and of the reference's
`cargo run --example simple_mul [gwc_kzg]` (examples/simple_mul.rs):
keygen, prove, self-verify with the spec verifier, verify the proof and its
tampered twin through ``TorchVerifier``, export artifacts.

Usage: python3 -m plutus_halo2_tpu_torch.examples.simple_mul [gwc_kzg] [--cpu] [--out DIR]
"""

from __future__ import annotations

from ..models.circuits import SimpleMulCircuit
from ..models.plan import FLAVOR_GWC, FLAVOR_HALO2
from ..refimpl.field import Q
from ..refimpl.keygen import keygen
from ..refimpl.prover import prove
from ..refimpl.verifier import verify
from ._common import device_of, device_verify, parser, write_set


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    flavor = FLAVOR_GWC if args.flavor == "gwc_kzg" else FLAVOR_HALO2
    dev = device_of(args)

    constant, a, b = 7, 2, 3
    c = constant * a * a * b * b
    circuit = SimpleMulCircuit(constant, a, b, c)
    inputs = [42, 42, 42]

    print(f"flavor: {flavor}")
    pk, plan = keygen(circuit, flavor=flavor, device=dev)
    print(f"k={plan.vk.k} n={plan.vk.n} blinding={plan.vk.blinding_factors}")

    proof = prove(pk, plan, circuit, inputs, device=dev)
    print(f"proof: {len(proof)} bytes")

    ok, _ = verify(plan, proof, inputs)
    print(f"spec verifier accepts: {ok}")
    assert ok

    # invalid proof: flip a byte inside the first scalar after the points
    # (the reference's examples do the same, examples/simple_mul.rs:113-120)
    bad = bytearray(proof)
    bad[48 * 2 + 2] ^= 0x40
    ok_bad, _ = verify(plan, bytes(bad), inputs)
    print(f"spec verifier rejects tampered proof: {not ok_bad}")
    assert not ok_bad

    # negated and trivial all-1 public inputs must reject (the reference
    # embeds the same negative cases, code_emitters_aiken.rs:594-639)
    ok_neg, _ = verify(plan, proof, [(-v) % Q for v in inputs])
    ok_triv, _ = verify(plan, proof, [1] * len(inputs))
    print(f"spec verifier rejects negated inputs: {not ok_neg}")
    print(f"spec verifier rejects trivial all-1 inputs: {not ok_triv}")
    assert not ok_neg and not ok_triv

    out = write_set(args.out, "simple_mul", plan, proof, bytes(bad), inputs)
    device_verify(plan, proof, bytes(bad), inputs, dev)
    return out


if __name__ == "__main__":
    main()
