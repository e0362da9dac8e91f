"""``qat_backward_bf16_roofline.train``: the bf16 QAT backward kernel's
share of its roofline (``counts.kernels``, row 8b): the least time of its
launches in the trace stage (one a quantized leaf a microbatch a step)
over the device time the trace gives them."""

from perfbench.counts import kernels

KERNEL = "qat_backward_bf16_kernel"


def read(data: dict):
    trace = data.get("trace")
    units = data["stages"]["trace"]["units"] if trace else 0
    if not units or KERNEL not in trace["kernels"]:
        return None
    m, spec = data["config"]["model"], data["spec"]
    per_step = spec["microbatches"] * sum(kernels.qat_backward_bf16_bound_s(n)
                                          for n in kernels.lm_quantized_leaf_weights(m))
    return 100.0 * units * per_step / trace["kernels"][KERNEL][0]
