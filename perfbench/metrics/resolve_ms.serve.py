"""``resolve_ms.serve``: milliseconds a forward in the engine's
``resolve_params`` (the LRU dequant cache materializing the wire leaves),
from the benchmark's synchronized span around it in a traced run's
``spans`` stage."""


def read(data: dict):
    spans = data["spans"].get("resolve")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
