"""lookup_table example — the port's counterpart of
``examples/lookup_table.py`` and of the reference's
`cargo run --example lookup_table` (examples/lookup_table.rs): a pow2
range-check circuit with a tag/value lookup table, proven and verified with
either multi-open flavor, through the spec verifier and ``TorchVerifier``.

Usage: python3 -m plutus_halo2_tpu_torch.examples.lookup_table [gwc_kzg] [--cpu] [--out DIR]
"""

from __future__ import annotations

from ..models.circuits import LookupRangeCircuit
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
    circuit = LookupRangeCircuit(values=(3, 9, 14), bits=4)
    inputs = [7]

    pk, plan = keygen(circuit, flavor=flavor, device=dev)
    print(f"flavor={flavor} k={plan.vk.k} n={plan.vk.n} lookups={len(plan.lookups)}")
    proof = prove(pk, plan, circuit, inputs, device=dev)
    print(f"proof: {len(proof)} bytes")
    ok, _ = verify(plan, proof, inputs)
    print(f"verifies: {ok}")
    assert ok

    # negative matrix (code_emitters_aiken.rs:594-639): tampered proof,
    # negated inputs, trivial all-1 inputs — all must reject
    bad = bytearray(proof)
    bad[48 * 2 + 2] ^= 0x40
    ok_bad, _ = verify(plan, bytes(bad), inputs)
    ok_neg, _ = verify(plan, proof, [(-v) % Q for v in inputs])
    ok_triv, _ = verify(plan, proof, [1] * len(inputs))
    print(f"rejects tampered/negated/trivial: {not ok_bad}/{not ok_neg}/{not ok_triv}")
    assert not (ok_bad or ok_neg or ok_triv)

    out = write_set(args.out, "lookup_table", plan, proof, bytes(bad), inputs, json_proof=False)
    device_verify(plan, proof, bytes(bad), inputs, dev)
    return out


if __name__ == "__main__":
    main()
