"""The keyed secure-mask kernel's share of its roofline, in percent: the
least time of the traced chunk's launches (``counts.keyed_bound_ms``: the
messages read and written against the Threefry cipher's integer
instructions at 64 lanes x SMs x the card's maximum SM clock) over their
summed device time."""
import subprocess

import torch

from portbench import counts

KERNEL = r"\bsecure_mask_keyed_kernel\b"


def read(run):
    ms, launches = run.trace.kernel_ms(KERNEL)
    if launches == 0 or not hasattr(run.cell, "keyed_bounds_ms"):
        return None
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bounds = run.cell.keyed_bounds_ms(counts.int32_rate(sms, mhz))
    if not bounds or len(bounds) != launches:
        return None
    return 100.0 * sum(bounds) / ms
