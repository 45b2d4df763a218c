"""The GWC19 multi-open's query grouping: the port's copy of
``group_queries_by_rotation`` from ``plutus_halo2_tpu/refimpl/multiopen.py``.
The port's verifier assembles both flavors' MSMs itself
(``models/verifier_torch.py``)."""

from __future__ import annotations


def group_queries_by_rotation(queries):
    """Group (rotation_key, commitment, eval) triples by rotation in
    first-occurrence order (GwcMultiOpenMSM.hs squashQueries:69-86,
    code_emitters_aiken.rs:764-782) -> [(rotation_key, [(commitment, eval)])]."""
    order: list = []
    groups: dict = {}
    for rot, comm, ev in queries:
        if rot not in groups:
            groups[rot] = []
            order.append(rot)
        groups[rot].append((comm, ev))
    return [(rot, groups[rot]) for rot in order]
