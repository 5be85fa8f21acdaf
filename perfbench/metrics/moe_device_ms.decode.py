"""Device time of the kernels launched inside ``moe.moe_apply`` during decode
steps, per decode step of the traced section, in milliseconds.  Nothing to
read without an MoE layer or decode steps."""

RANGE = "perfbench.moe.decode_step"


def read(r):
    if r.trace is None or not r.traced_decode_steps:
        return None
    spent = r.trace.device_time_under(RANGE)
    if spent <= 0:
        return None
    return 1e3 * spent / r.traced_decode_steps
