"""Verification tracing — the analog of the reference's `plutus_debug` traces:
the port's copy of ``plutus_halo2_tpu/utils/tracing.py``.

The reference's Plinth emitter can fill a {{TRACES}} slot with labeled values
of every challenge, gate evaluation, and query (code_emitters_plinth.rs:680-776,
BlsUtils.hs:66-117). Here the refimpl verifier exposes the same intermediates
via `verify(..., collect_traces=True)`, and this module renders them and
diffs two trace sets — the bit-exactness debugging tool for spec-vs-device
work: in the port, the spec's ``el`` / ``er`` against ``TorchVerifier.core``'s
``el`` and ``-er`` in affine coordinates (``device_traces``)."""

from __future__ import annotations


def format_traces(traces: dict) -> str:
    lines = []
    for key, val in traces.items():
        if isinstance(val, tuple) and len(val) == 2:  # G1 point
            lines.append(f"{key}: G1(x={val[0]:#x}, y={val[1]:#x})")
        elif isinstance(val, int):
            lines.append(f"{key}: {val:#x}")
        else:
            lines.append(f"{key}: {val}")
    return "\n".join(lines)


def diff_traces(a: dict, b: dict) -> list[str]:
    """Keys whose values differ (present in both)."""
    out = []
    for k in a:
        if k in b and a[k] != b[k]:
            out.append(k)
    return out


def device_traces(verifier, proof_bytes, public_inputs, y_hints=None, sub_weights=None) -> list[dict]:
    """The spec's pairing-side traces as the batched verifier computes them:
    per row, {"el": el, "er": -er} of ``verifier.core`` (a TorchVerifier) as
    affine points (None for the identity), ready for ``diff_traces``
    against ``refimpl.verifier.verify(..., collect_traces=True)``."""
    from ..ops import curve as tc

    el, er, _valid = verifier.core(proof_bytes, public_inputs, y_hints, sub_weights)
    el, er = el.cpu().numpy(), tc.neg(er).cpu().numpy()
    return [{"el": tc.host_point_from_mont(el[b]), "er": tc.host_point_from_mont(er[b])}
            for b in range(el.shape[0])]
