"""``qat_backward_roofline.fed``: the fp32 QAT backward kernel's share of
its roofline (``counts.kernels``, row 8): the least time of its launches in
the trace stage (one a quantized leaf a local step) over the device time
the trace gives them."""

from perfbench.counts import kernels, model

KERNEL = "qat_backward_kernel"


def read(data: dict):
    trace = data.get("trace")
    units = data["stages"]["trace"]["units"] if trace else 0
    if not units or KERNEL not in trace["kernels"]:
        return None
    per_step = sum(kernels.qat_backward_bound_s(k * k * ci * co)
                   for _, _, k, ci, co in model.resnet_convs(data["config"]["model"]))
    m = data["config"]["model"]
    per_step += kernels.qat_backward_bound_s(m["width"] * m["n_classes"])
    return 100.0 * units * data["local_steps_per_round"] * per_step / trace["kernels"][KERNEL][0]
