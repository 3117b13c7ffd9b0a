"""The payload-merge kernel's share of its roofline, in percent: X read and written
once, the (N, k) index and value payloads and the (N, K) tables read once
(``counts.payload_bound_ms``), over its mean device time in the traced
chunk."""

from portbench import counts

KERNEL = r"\bpayload_mix_rows_kernel\b"


def read(run):
    ms, launches = run.trace.kernel_ms(KERNEL)
    shape = run.cell.payload_shape() if hasattr(run.cell, "payload_shape") else None
    if launches == 0 or shape is None:
        return None
    return 100.0 * counts.payload_bound_ms(*shape) / (ms / launches)
