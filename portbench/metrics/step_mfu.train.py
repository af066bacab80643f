"""Whole training step: model FLOPs of the window's steps over the window's
seconds at the bf16 tensor peak, in %. FLOPs come from the configuration's
shapes (the reference's ``flops_per_token``: forward and backward, no
recomputation), never from what the program executed."""

from portbench import peaks


def read(reading: dict) -> float | None:
    steps = len(reading["step_s"])
    if not steps:
        return None
    flops = reading["flops_per_token"] * reading["tokens_per_step"] * steps
    return 100.0 * flops / (reading["window_s"] * peaks.BF16_TENSOR_FLOPS)
