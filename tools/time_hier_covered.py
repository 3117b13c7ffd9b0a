"""Time the host read of the hierarchical cohort selection on one card.

    python3 tools/time_hier_covered.py [STEPS]

``AsyncScheduler._select_hier`` reads its ``covered`` predicate (are all
in-slice segments among the K selected?) on the host each step, where the
reference branches on the device with ``lax.cond``.  This script builds
``chip_smoke.py``'s million-node engine (N=1,000,000, C=8192, int8 cold
rows, the spread clock) twice from the same seed and runs STEPS event
steps (default 64, in spans of 8, after one warm-up span) on each,
alternating A, B, A, B:

* A: the engine as it is (one host read per step);
* B: the same steps with the selection taken from the segments alone and
  ``covered`` accumulated on the device and read once at the end (valid
  only when every step was covered, which it checks).

It prints the steps per second of each run, the difference per step, the
two engines' parameters and event counts compared bitwise, and each
run's card and power limit; then one span of A under ``torch.profiler``
(``chip_smoke.profile_call``: the device's busy time and idle share).
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on sys.path)


def no_read(sched):
    """Make ``sched`` select from the segments without a host read; the
    steps that were not covered are counted on the device."""
    import torch

    sched._uncovered = torch.zeros((), dtype=torch.int64, device=sched._t_next.device)

    def select(t_next, seg_min):
        theta = seg_min.min() + sched.eng.dl.async_slice_s
        sched._uncovered += ((seg_min <= theta).sum() > sched._seg_k).to(torch.int64)
        return sched._select_segments(t_next, seg_min, theta) + (0,)

    sched._select_hier = select


def timed(eng, start, steps):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(start, start + steps, eng.chunk):
        eng.scheduler.run_span(s, eng.chunk)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t)


def main(argv=None):
    import torch

    steps = int((argv or sys.argv[1:] or [64])[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    engs = {}
    for name in ("A", "B"):
        engs[name] = cs.population_engine(cs.MILLION_N, cs.POP_C, selection="hier", cold="int8",
                                          spread=cs.POP_SPREAD,
                                          slice_s=cs.slice_for(cs.MILLION_N, cs.POP_C))
        engs[name].scheduler.run_span(0, engs[name].chunk)
    no_read(engs["B"].scheduler)
    rates = {"A": [], "B": []}
    start = engs["A"].chunk
    for rep in range(2):
        for name in ("A", "B"):
            rates[name].append(timed(engs[name], start, steps))
        start += steps
    a, b = engs["A"].scheduler, engs["B"].scheduler
    uncovered = int(b._uncovered)
    same = (torch.equal(a._events, b._events)
            and all(torch.equal(x.q, y.q) and torch.equal(x.s, y.s)
                    for x, y in zip(a._cold_params.values(), b._cold_params.values())))
    ms = {k: [1e3 / r for r in v] for k, v in rates.items()}
    print(f"[hier-read] {smi}: N={cs.MILLION_N} C={cs.POP_C} {steps} steps per run; "
          f"A (a host read per step) steps/s {rates['A']}, ms/step {ms['A']}; B (no read) "
          f"steps/s {rates['B']}, ms/step {ms['B']}; A - B ms/step "
          f"{[x - y for x, y in zip(ms['A'], ms['B'])]}; uncovered steps in B {uncovered}; "
          f"A and B bitwise equal: {same}", flush=True)
    if uncovered or not same:
        raise AssertionError("B's steps were not all covered, or A and B parted")
    cs.profile_call(f"one span of {engs['A'].chunk} million-node steps (A)",
                    lambda: engs["A"].scheduler.run_span(start, engs["A"].chunk))
    return 0


if __name__ == "__main__":
    sys.exit(main())
