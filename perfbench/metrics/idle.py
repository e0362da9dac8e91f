"""``idle.<kind>``: the share of the trace stage in which no operation ran
on the device (``trace.reduce``'s busy seconds over the stage's length)."""


def read(data: dict):
    trace = data.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
