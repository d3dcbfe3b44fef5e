"""What fresh host memory and pageable copies cost on the host it runs on.

    python experiments/host_memory_probe.py [--rounds 40]

The resident build's host side allocates its buffers anew each call: the
pack's int64 temporaries, the scatter's index and value arrays, and the
readback's ``torch.cat(...).cpu()``.  This times, per size, the median and
the 10th and 90th percentile of ``--rounds`` repetitions of:

* ``fresh``: ``np.empty`` of the size, then one write over it (first touch);
* ``reused``: the same write into one buffer kept across repetitions;
* on a card, ``d2h_pageable``: a device int64 tensor of the size read back
  with ``.cpu()`` (a fresh pageable buffer, as ``_to_host`` does);
  ``d2h_pinned``: the same copied into one pinned buffer kept across
  repetitions, then synchronized;
* ``h2d_pageable``: ``torch.from_numpy(a).to(device)``;
  ``h2d_pinned``: the same array copied into a kept pinned buffer on the
  host, then sent from it.

Prints the card's name and power limit, the transparent-huge-page
settings, then one JSON line per size.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def stats(xs):
    x = np.asarray(xs) * 1000
    return [round(float(np.median(x)), 4), round(float(np.percentile(x, 10)), 4),
            round(float(np.percentile(x, 90)), 4)]


def read(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return str(e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--sizes-mb", type=float, nargs="+", default=[1, 7, 14, 27, 64])
    args = ap.parse_args(argv)
    cuda = torch.cuda.is_available()
    card = "cpu"
    if cuda:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
        card = r.stdout.strip()
    print(json.dumps({"card": card,
                      "thp": read("/sys/kernel/mm/transparent_hugepage/enabled"),
                      "thp_defrag": read("/sys/kernel/mm/transparent_hugepage/defrag")}),
          flush=True)
    dev = torch.device("cuda", 0) if cuda else None
    for mb in args.sizes_mb:
        n = int(mb * 1e6) // 8
        t = {k: [] for k in ("fresh", "reused", "d2h_pageable", "d2h_pinned", "h2d_pageable",
                             "h2d_pinned")}
        keep = np.empty(n, np.int64)
        keep.fill(1)
        for _ in range(args.rounds):
            a = time.perf_counter()
            x = np.empty(n, np.int64)
            x.fill(2)
            t["fresh"].append(time.perf_counter() - a)
            del x
            a = time.perf_counter()
            keep.fill(3)
            t["reused"].append(time.perf_counter() - a)
        if cuda:
            d = torch.arange(n, dtype=torch.int64, device=dev)
            pinned = torch.empty(n, dtype=torch.int64, pin_memory=True)
            src = np.arange(n, dtype=np.int64)
            torch.cuda.synchronize()
            for _ in range(args.rounds):
                a = time.perf_counter()
                h = d.cpu().numpy()
                t["d2h_pageable"].append(time.perf_counter() - a)
                del h
                a = time.perf_counter()
                pinned.copy_(d, non_blocking=True)
                torch.cuda.synchronize()
                t["d2h_pinned"].append(time.perf_counter() - a)
                a = time.perf_counter()
                g = torch.from_numpy(src).to(dev)
                torch.cuda.synchronize()
                t["h2d_pageable"].append(time.perf_counter() - a)
                del g
                a = time.perf_counter()
                pinned.numpy()[:] = src
                g = pinned.to(dev, non_blocking=True)
                torch.cuda.synchronize()
                t["h2d_pinned"].append(time.perf_counter() - a)
                del g
        print(json.dumps({"mb": mb, **{k: stats(v) for k, v in t.items() if v}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
