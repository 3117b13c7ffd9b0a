"""Device operations (kernels, copies, sets) per trainer step in the
traced chunk: the host's dispatch work a step."""


def read(run):
    if not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.steps
