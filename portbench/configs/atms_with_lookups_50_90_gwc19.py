"""atms_with_lookups_50_90_gwc19's circuit structure for the benchmark's
reference: the halo2-book configuration's, loaded from
``atms_with_lookups_50_90.py`` beside this file (the multi-open flavor is
not part of the structure). Like it, it imports nothing of the port."""

from __future__ import annotations

from pathlib import Path

from portbench import spec as _spec

_BOOK = _spec.load_module(Path(__file__).with_name("atms_with_lookups_50_90.py"), "atms_with_lookups_50_90")

NUM_PUBLIC_INPUTS = _BOOK.NUM_PUBLIC_INPUTS
spec = _BOOK.spec
