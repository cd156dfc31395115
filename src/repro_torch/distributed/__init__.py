"""Multi-device training and its parts (port of ``repro/distributed``):
the single-controller mesh's collectives (``collectives``), the sharding
rules and their runtime layer (``sharding``), gradient compression and
``compressed_psum`` (``compression``), the GPipe pipeline (``pipeline``)
and fault tolerance (``fault``)."""
