"""Cost of sorting the wavefront's lanes on the card, at the queue's
width: the counterpart of tools/exp_sortcost.py.

Times the five operations of the reference's experiment at N = 320k lanes
and 26 carry planes: the sort key (a 4x4x4 grid cell of the origin and the
direction's octant), argsort, sort with the lane index, the permutation of
26 float planes, and the three together.  `torch.sort` / `torch.argsort`
on the card, CUDA events around 10 calls after a warm-up call.  A's
divergence bound (an all-lambertian Cornell takes 19.1% less card time a
traced ray) caps what sorting lanes by material could buy; these times
are what a sort would cost per wavefront iteration.

Run:  python tools/exp_sortcost_torch.py
One JSON line per operation, then the card's name and power limit as
nvidia-smi gives them.  Needs a CUDA device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N = 320 * 1024
K_PLANES = 26    # queue carry: ~26 [N] planes get permuted
ITERS = 10


def keyfn(o, d):
    """Sort key per lane: the cell of the origin in a 4x4x4 grid over
    [-10, 10)^3 (clamped), times 8, plus the direction's octant."""
    import torch

    oct_ = ((d[0] < 0).to(torch.int32) + 2 * (d[1] < 0).to(torch.int32)
            + 4 * (d[2] < 0).to(torch.int32))
    cell = 0
    for ax in range(3):
        q = torch.clamp(((o[ax] + 10.0) * (4.0 / 20.0)).to(torch.int32),
                        0, 3)
        cell = cell * 4 + q
    return cell * 8 + oct_


def argsort_only(k):
    import torch

    return torch.argsort(k)


def sort_iota(k):
    import torch

    return torch.sort(k).indices


def permute(perm, planes):
    return [p[perm] for p in planes]


def full(o, d, planes):
    return permute(sort_iota(keyfn(o, d)), planes)


def inputs(device, seed=0):
    """The reference's inputs (numpy default_rng(0)): keys in [0, 512), 26
    uniform planes, origins in [-10, 10) and directions in [-1, 1), as
    float32 / int32 tensors on `device`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=device)

    keys = t(rng.integers(0, 512, N).astype(np.int32))
    planes = [t(rng.uniform(size=N).astype(np.float32))
              for _ in range(K_PLANES)]
    o = [t(rng.uniform(-10, 10, N).astype(np.float32)) for _ in range(3)]
    d = [t(rng.uniform(-1, 1, N).astype(np.float32)) for _ in range(3)]
    return keys, planes, o, d


def _time_ms(fn, *args):
    import torch

    fn(*args)                                 # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def run(device="cuda") -> dict:
    """{operation: ms per call} on `device`, which must be a CUDA card
    (CUDA events time it); without CUDA it raises."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("exp_sortcost times on the card: it needs a CUDA "
                           "device")
    keys, planes, o, d = inputs(device)
    return {
        "keyfn": _time_ms(keyfn, o, d),
        "argsort": _time_ms(argsort_only, keys),
        "sort_iota": _time_ms(sort_iota, keys),
        "permute26": _time_ms(permute, torch.argsort(keys), planes),
        "full_sort": _time_ms(full, o, d, planes),
    }


def main() -> int:
    from rtw_tpu_torch.utils.profiling import card_line

    for name, ms in run().items():
        print(json.dumps({"name": name, "ms": ms}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
