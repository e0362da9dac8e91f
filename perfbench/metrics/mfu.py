"""``mfu.<kind>``: the model FLOPs of the whole units of a traced run's
``host`` stage (nothing attached: no profiler, no synchronizing timer) over
its wall time, as a share of the card's dense peak in the configuration's
dtype. FLOPs a unit (``counts.model``, no recompute) by the cell's driver:
a train step 6·N a token plus attention, a scoring forward 2·N a token plus
attention, a federated round 3 forwards of ResNet18* a sample trained."""

from perfbench.counts import model, peaks


def flops_per_unit(driver: str, m: dict, spec: dict, layer: dict) -> float | None:
    if driver == "train":
        return model.lm_train_flops(m, spec["batch"], spec["seq"])
    if driver == "score":
        return model.lm_forward_flops(m, spec["max_batch"], spec["prompt_len"])
    if driver == "fed":
        return layer["samples_per_round"] * model.resnet_train_flops(m)
    return None


def read(data: dict):
    host = (data.get("stages") or {}).get("host")
    if not host or not host["units"] or not host["seconds"]:
        return None
    per = flops_per_unit(data["spec"]["driver"], data["config"]["model"], data["spec"], data)
    if per is None:
        return None
    return 100.0 * host["units"] * per / host["seconds"] / peaks.PEAK_FLOPS[data["config"]["dtype"]]
