"""The gather-merge kernel's share of its roofline, in percent: the least time of
out[n] = sum_k w[n,k] X[rows[n,k]] at the cell's operands
(``counts.merge_bound_ms``) over the kernel's mean device time in the
traced chunk."""

from portbench import counts

KERNEL = r"\bgossip_mix_rows_kernel\b"


def read(run):
    ms, launches = run.trace.kernel_ms(KERNEL)
    if launches == 0:
        return None
    return 100.0 * counts.merge_bound_ms(*run.cell.merge_shape()) / (ms / launches)
