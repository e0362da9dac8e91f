"""``codec_ms.fed``: milliseconds a round in the codec, from the server's
``PhaseTimer``: the broadcast's re-quantization, every upload's encode and
the wire's serialization and decoding ("requantize", "encode", "wire")."""


def read(data: dict):
    phases = data.get("phases")
    if not phases:
        return None
    names = ("requantize", "encode", "wire")
    return 1e3 * sum(p.get(n, 0.0) for p in phases for n in names) / len(phases)
