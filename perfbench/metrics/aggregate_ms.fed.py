"""``aggregate_ms.fed``: milliseconds a round of the server's fan-in
(``Aggregator.add`` of every upload and its ``finalize``), from the
server's ``PhaseTimer`` ("aggregate")."""


def read(data: dict):
    phases = data.get("phases")
    if not phases:
        return None
    return 1e3 * sum(p.get("aggregate", 0.0) for p in phases) / len(phases)
