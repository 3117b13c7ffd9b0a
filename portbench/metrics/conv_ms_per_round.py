"""Device milliseconds of the convolutions (cuDNN's forward, data-gradient
and weight-gradient kernels) per round of the traced chunk, its
evaluation included.  Summed kernel times: kernels that overlap in time
each count in full."""

PATTERN = r"(?i)conv|cudnn|implicit|wgrad|dgrad|fprop"


def read(run):
    ms, launches = run.trace.kernel_ms(PATTERN)
    if launches == 0:
        return None
    return ms / run.trace.steps
