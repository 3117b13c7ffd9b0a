"""The temporaries that aten ops allocate and free inside themselves on the
card, which the dry run's live-storage tracker cannot see, for each of
``chip_smoke.py``'s ``[dryrun]`` calibration cases (C1-C4).

    python3 tools/dryrun_transients.py

Each case's step runs once to warm up, then once under a dispatch mode
that reads ``torch.cuda.memory_allocated()`` before and after every op and
``max_memory_allocated()`` over it (its peak reset just before).  Per op
name it prints the calls whose peak rose above both sides by more than
1 MiB and the largest such rise with the first input shapes, then the op
at which the step reached the allocator's peak.  An op listed here and
at a peak is one for ``launch/dryrun.py``'s ``_INTERNAL`` table.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr

    if not torch.cuda.is_available():
        print("dryrun_transients: no CUDA device", file=sys.stderr)
        return 2

    class Transients(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows, self.trace = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
            self.trace.append((str(func), peak))
            if peak - max(before, after) > (1 << 20):
                shapes = [(tuple(a.shape), str(a.dtype)) for a in dr._tensors((args, kwargs))]
                self.rows.append((str(func), peak - max(before, after), str(shapes[:3])))
            return out

    for label, arch, dtype, mode, n, b, s, depth in cs.DRYRUN_CASES:
        cfg = get_config(arch).replace(dtype=dtype)
        if depth:
            cfg = cfg.replace(n_layers=depth)
        cs.release()
        fn, args = dr.build_step(cfg, mode, n, b, s, device="cuda")
        fn(*args)
        torch.cuda.synchronize()
        with Transients() as m:
            fn(*args)
        torch.cuda.synchronize()
        by_op = {}  # op -> [calls, the largest rise, its inputs]
        for name, extra, shapes in m.rows:
            rec = by_op.setdefault(name, [0, 0, ""])
            rec[0] += 1
            if extra > rec[1]:
                rec[1:] = [extra, shapes]
        at = max(range(len(m.trace)), key=lambda i: m.trace[i][1])
        print(f"[transients] {label}: {len(m.trace)} ops; above 1 MiB (calls, largest, inputs): "
              f"{json.dumps(by_op)}; the allocator's peak {m.trace[at][1]} B at op {at} "
              f"{m.trace[at][0]}", flush=True)
        del fn, args, m
    return 0


if __name__ == "__main__":
    sys.exit(main())
