"""FTTQ statistics, the ternary wire tensor, codecs and the fused encode
(port of ``repro.core``, serving subset)."""
