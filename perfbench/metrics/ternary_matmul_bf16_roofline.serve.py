"""``ternary_matmul_bf16_roofline.serve``: the bf16 packed ternary matmul's
share of its roofline (``counts.kernels``, row 2d): the least time of every
packed weight matmul of the trace stage's forwards over the device time
the trace gives the kernel (its prefill and decode entries)."""

from perfbench.counts import kernels

NAMES = ("prefill_kernel", "decode_kernel")


def read(data: dict):
    trace = data.get("trace")
    busy = sum(trace["kernels"][k][0] for k in NAMES if k in trace["kernels"]) if trace else 0
    units = data["stages"]["trace"]["units"] if trace else 0
    if not busy or not units:
        return None
    m = data["config"]["model"]
    per_forward = sum(kernels.ternary_matmul_bf16_bound_s(*mkn)
                      for mkn in kernels.lm_ternary_matmuls(m, data["rows"]))
    return 100.0 * units * per_forward / busy
