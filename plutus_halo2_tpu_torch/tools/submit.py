"""Submit proof artifacts to a local VerificationService: the port of
``tools/submit.py``, the analog of `cargo run --bin submitter`
(aiken-verifier/submitter/src/main.rs), which reads serialized_proof.hex /
serialized_public_input.hex, tags the submission with
blake2b_256(proof ∥ inputs), submits it and polls.

The JAX tool proves at run time; this one reads a committed artifact set
(``utils/artifacts.py``), the bytes the port's prover makes from the same
defaults:
``--circuit`` names it, and ``--flavor gwc19`` takes simple_mul's GWC19 set.
Every third submission is a tampered proof. For each submission it prints
the tag and the verdict, at the end the dispatch count and the device. Runs
on the card unless ``--cpu`` is given.

    python3 -m plutus_halo2_tpu_torch.tools.submit [--circuit simple_mul|lookup_table|atms|
        atms_with_lookups|atms_228_408] [--flavor halo2|gwc19] [--copies N] [--batch B] [--cpu]
"""

from __future__ import annotations

import argparse
import time

CIRCUITS = ("simple_mul", "lookup_table", "atms", "atms_with_lookups", "atms_228_408")


def main(argv=None) -> list[tuple[bytes, bool]]:
    """Returns each submission's (tag, accepted), in submission order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--circuit", default="simple_mul", choices=CIRCUITS)
    ap.add_argument("--flavor", default="halo2", choices=["halo2", "gwc19"])
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if args.flavor == "gwc19" and args.circuit != "simple_mul":
        ap.error("the committed GWC19 set is simple_mul's")

    from ..models.verifier_torch import resolve_device
    from ..serving import ProofBundle, VerificationService
    from ..utils.artifacts import load_set

    plan, proof, _invalid, inputs = load_set("simple_mul_gwc19" if args.flavor == "gwc19" else args.circuit)
    dev = resolve_device("cpu" if args.cpu else None)
    svc = VerificationService(plan, batch_size=args.batch, device=dev)
    try:
        futures = []
        t0 = time.time()
        for i in range(args.copies):
            p = bytearray(proof)
            if i % 3 == 2:  # every third submission is a tampered proof
                p[100] ^= 0x40
            futures.append(svc.submit(ProofBundle(bytes(p), tuple(inputs))))
        results = []
        for i, fut in enumerate(futures):
            tag, ok = fut.result(timeout=600)
            print(f"submission {i}: tag={tag.hex()[:16]}… accepted={ok}")
            results.append((tag, ok))
        dt = time.time() - t0
    finally:
        svc.close()
    print(f"{len(futures)} submissions in {dt:.2f}s ({svc.dispatches} device dispatches, device={dev})")
    return results


if __name__ == "__main__":
    main()
