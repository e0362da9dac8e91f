"""FTTQ statistics and QAT quantizer, the ternary wire tensor, codecs, the
fused encode and the T-FedAvg protocol pieces (port of ``repro.core``)."""
