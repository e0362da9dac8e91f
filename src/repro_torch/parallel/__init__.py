"""Multi-device: the client-sharded fan-in, the ternary-compressed
collectives and the sharding rules (port of ``repro.parallel``)."""
