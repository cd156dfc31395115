"""Fault tolerance and gradient compression of the port (port of
``repro/distributed``'s single-device parts; the sharding rules, the
pipeline and ``compressed_psum`` come with multi-device training)."""
