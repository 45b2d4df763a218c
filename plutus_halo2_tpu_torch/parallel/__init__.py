"""Multi-device verification: the port of ``plutus_halo2_tpu/parallel``
(``mesh.py``: batch data-parallel verification, dp x mp with a
point-sharded MSM, multi-process initialization)."""
