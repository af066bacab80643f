"""sLSTM's recurrence (``kernels/slstm_scan``, forward and backward): the
launches' least time over their device time, in %.

A launch covers one microbatch of B rows over S steps at width d. Its least
time is the larger of its operations and its bytes:

* operations: the recurrent product, 2·B·S·d·4d FLOPs each way (h·R
  forward, dpre·Rᵀ backward), at the bf16 tensor peak, plus the cell at
  the FP32 peak — 24 operations a (row, unit, step) forward as the
  equations are written (4 adds to the gates, 3 activations, 2 for the
  stabilizer, 2 exponentials with their 2 differences, 5 for c and n, 4
  for the normalizer, 2 for h), twice that backward;
* bytes, each read or written once: forward the gates' input projections
  ``[B, S, 4d]`` float32 and R in, h ``[B, S, d]`` float32 out; backward
  the gates' pre-activations and dh in with R, their gradient out.
"""

from portbench import peaks

FORWARD, BACKWARD = "slstm_fwd", "slstm_bwd"
CELL_FLOPS = {FORWARD: 24, BACKWARD: 48}


def bound_s(kind: str, rows: int, steps: int, d: int, r_itemsize: int) -> float:
    """Least seconds of one ``kind`` launch."""
    product = 2 * rows * steps * d * 4 * d / peaks.BF16_TENSOR_FLOPS
    cell = CELL_FLOPS[kind] * rows * steps * d / peaks.FP32_FLOPS
    r_bytes = 4 * d * d * r_itemsize
    if kind == FORWARD:
        moved = 4 * rows * steps * (4 * d + d) + r_bytes
    else:
        moved = 4 * rows * steps * (4 * d + d + 4 * d) + r_bytes
    return max(product + cell, moved / peaks.HBM_BYTES_PER_S)


def read(reading: dict) -> float | None:
    trace = reading["trace"]
    if trace is None:
        return None
    d = reading["model"]["d_model"]
    itemsize = 2 if reading["model"]["param_dtype"] == "bfloat16" else 4
    least = spent = 0.0
    for kind in (FORWARD, BACKWARD):
        times = trace.durations(kind)
        least += len(times) * bound_s(kind, reading["rows"],
                                      reading["seq_len"], d, itemsize)
        spent += sum(times)
    return 100.0 * least / spent if spent else None
