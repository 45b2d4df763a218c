"""ATMS example — the port's counterpart of ``examples/atms.py`` and
of the reference's `cargo run --example atms [gwc_kzg]` and
`--example atms_with_lookups` (examples/atms.rs, examples/atms_with_lookups.rs):
prepare threshold signatures, keygen, prove, self-verify with the spec
verifier, verify the proof and its tampered twin through ``TorchVerifier``,
export artifacts.

Usage: python3 -m plutus_halo2_tpu_torch.examples.atms [gwc_kzg] [--lookups]
           [--parties N] [--threshold T] [--cpu] [--out DIR]

At 90 parties and threshold 50 (the reference's benchmark scale,
README.md:220-221) it writes the sets ``atms_50_90_*`` and
``atms_with_lookups_50_90_*`` that the bench reads.
"""

from __future__ import annotations

import time

from ..models.atms import AtmsCircuit, AtmsLookupCircuit, prepare_test_signatures
from ..models.layout import build_layout
from ..models.plan import FLAVOR_GWC, FLAVOR_HALO2
from ..refimpl.keygen import keygen
from ..refimpl.prover import prove
from ..refimpl.verifier import verify
from ._common import device_of, device_verify, parser, write_set

MSG = 424242


def set_name(parties: int, threshold: int, lookups: bool) -> str:
    name = "atms_with_lookups" if lookups else "atms"
    if (parties, threshold) != (2, 1):
        # non-default scale (e.g. the reference's 50/90 and 228/408 benchmark
        # scales, README.md:220-221): keep the default artifacts intact
        name = f"{name}_{threshold}_{parties}"
    return name


def prove_set(parties: int, threshold: int, lookups: bool, flavor: str = FLAVOR_HALO2, device=None) -> dict:
    """The example's proof at a scale: the signatures of
    ``prepare_test_signatures(parties, threshold, MSG)``, keygen with the
    default SRS, prove with the default seed, on `device`."""
    cls = AtmsLookupCircuit if lookups else AtmsCircuit
    pks, sigs, _pks_comm = prepare_test_signatures(parties, threshold, MSG)
    circuit = cls(pks, sigs, MSG, threshold)
    inputs = circuit.public_inputs()

    t0 = time.time()
    pk, plan = keygen(circuit, flavor=flavor, device=device)
    keygen_s = time.time() - t0
    print(f"k={plan.vk.k} n={plan.vk.n} perm_sets={plan.num_permutation_sets} "
          f"lookups={len(plan.lookups)} keygen={keygen_s:.1f}s")

    t0 = time.time()
    proof = prove(pk, plan, circuit, inputs, device=device)
    prove_s = time.time() - t0
    print(f"proof: {len(proof)} bytes in {prove_s:.1f}s")
    return {"plan": plan, "proof": proof, "inputs": inputs, "keygen_s": keygen_s, "prove_s": prove_s}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--lookups", action="store_true", help="the lookup variant")
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--threshold", type=int, default=1)
    args = ap.parse_args(argv)
    flavor = FLAVOR_GWC if args.flavor == "gwc_kzg" else FLAVOR_HALO2
    dev = device_of(args)
    n_parties, threshold, msg = args.parties, args.threshold, MSG
    name = set_name(n_parties, threshold, args.lookups)
    print(f"circuit: {name}  flavor: {flavor}  parties: {n_parties}  threshold: {threshold}")
    made = prove_set(n_parties, threshold, args.lookups, flavor, dev)
    plan, proof, inputs = made["plan"], made["proof"], made["inputs"]

    ok, _ = verify(plan, proof, inputs)
    print(f"spec verifier accepts: {ok}")
    assert ok

    # circuit-correct flip offset: the first scalar byte after the G1
    # commitment prefix, the reference's per-circuit choice (atms.rs:111 uses
    # 48*16+2, atms_with_lookups.rs:135 uses 48*20+2) — derived here from the
    # plan's own static layout instead of a hard-coded point count
    first_scalar = min(build_layout(plan).scalar_offsets.values())
    bad = bytearray(proof)
    bad[first_scalar + 2] ^= 0x40
    print(f"invalid-proof flip offset: {first_scalar + 2} "
          f"(= first scalar + 2; {first_scalar // 48} leading points)")
    ok_bad, _ = verify(plan, bytes(bad), inputs)
    print(f"spec verifier rejects tampered proof: {not ok_bad}")
    assert not ok_bad

    ok_msg, _ = verify(plan, proof, [inputs[0], msg + 1, threshold])
    print(f"spec verifier rejects wrong message: {not ok_msg}")
    assert not ok_msg

    # trivial all-1 inputs (code_emitters_aiken.rs:627-639) must reject
    ok_triv, _ = verify(plan, proof, [1] * len(inputs))
    print(f"spec verifier rejects trivial all-1 inputs: {not ok_triv}")
    assert not ok_triv

    out = write_set(args.out, name, plan, proof, bytes(bad), inputs)
    device_verify(plan, proof, bytes(bad), inputs, dev)
    print(f"seconds: keygen {made['keygen_s']:.3f} prove {made['prove_s']:.3f} ({dev.type})")
    return out


if __name__ == "__main__":
    main()
