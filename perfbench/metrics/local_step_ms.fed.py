"""``local_step_ms.fed``: milliseconds of client local training a local
step, from the server's ``PhaseTimer`` ("train", synchronized at its end)
over the rounds of a traced run's ``spans`` stage."""


def read(data: dict):
    phases, per_round = data.get("phases"), data.get("local_steps_per_round")
    if not phases or not per_round:
        return None
    return 1e3 * sum(p.get("train", 0.0) for p in phases) / (len(phases) * per_round)
