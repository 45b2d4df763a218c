"""What the example scripts share: their command line, the output
directory, the device verification and the artifact files."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..models.verifier_torch import TorchVerifier, resolve_device
from ..utils.serialization import export_proof, export_public_inputs, serialize_proof, vk_to_json

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "chiprun_out" / "examples"


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("flavor", nargs="?", choices=["gwc_kzg"], help="the GWC19 multi-open flavor")
    ap.add_argument("--cpu", action="store_true", help="prove and verify with the plain versions on the CPU")
    ap.add_argument("--out", default=str(OUT), help="the directory of the artifact files")
    return ap


def device_of(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else None)


def device_verify(plan, proof: bytes, bad: bytes, inputs, device) -> list[bool]:
    """The proof and its tampered twin through ``TorchVerifier.verify``
    (y-hints, the aggregate subgroup test): must give [True, False]."""
    v = TorchVerifier(plan, device=device)
    batch = np.stack([np.frombuffer(proof, np.uint8), np.frombuffer(bad, np.uint8)])
    pis = torch.from_numpy(v.encode_public_inputs([inputs] * 2)).to(device)
    hints = torch.from_numpy(v.compute_y_hints(batch)).to(device)
    out = v.verify(torch.from_numpy(batch).to(device), pis, hints, torch.Generator().manual_seed(0))
    verdicts = out.cpu().tolist()
    print(f"device verdicts ({device.type}, proof and tampered twin): {verdicts}")
    assert verdicts == [True, False]
    return verdicts


def write_set(out_dir, name: str, plan, proof: bytes, bad: bytes, inputs, json_proof: bool = True) -> Path:
    """{name}_proof.hex, _proof_invalid.hex, _public_input.hex, _vk.json
    (and _proof.json) in `out_dir`, as the JAX package's examples write them."""
    out = Path(out_dir)
    os.makedirs(out, exist_ok=True)
    files = {"proof.hex": export_proof(proof), "proof_invalid.hex": export_proof(bad),
             "public_input.hex": export_public_inputs(inputs), "vk.json": vk_to_json(plan.vk)}
    if json_proof:
        files["proof.json"] = serialize_proof(proof)
    for suffix, text in files.items():
        (out / f"{name}_{suffix}").write_text(text)
    print(f"artifacts written to {out}")
    return out
