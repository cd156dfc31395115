"""Fault tolerance, gradient compression and the sharding rule tables of
the port (port of ``repro/distributed``: the single-device parts, and the
rule half of ``sharding.py`` that the dry-run reads; the runtime sharding
layer, the pipeline and ``compressed_psum`` come with multi-device
training)."""
