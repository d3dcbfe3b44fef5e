"""The BAM filter cascade as a device mask on torch tensors (counterpart of
``gci_tpu/filters/device.py``).

The same predicates as ``filters.cascade.bam_filter_mask`` (GCI.py:156,165),
evaluated elementwise in float32 on the tensors' device, in the reference's
order of operations: the ratios are compared as products, so a record with
no aligned bases is decided without a division.  It is not the float64 host
mask that ``pipeline.run_filter`` applies for byte parity with the
reference, and no path of the pipeline calls it; on a tie or an empty
alignment it may decide otherwise than that mask.
"""
from __future__ import annotations

import torch

FLAG_EXCLUDE = 4 | 256 | 2048  # unmapped | secondary | supplementary


def bam_filter_mask_device(
    flag, mapq, m, i, d, s, eq, x, nm,
    map_qual: int = 30,
    clip_percent: float = 0.1,
    iden_percent: float = 0.9,
) -> torch.Tensor:
    """Bool tensor of the records that pass, from the BAM columns as
    integer tensors on one device."""
    base = ((flag & FLAG_EXCLUDE) == 0) & (mapq >= map_qual)
    mf = m.to(torch.float32)
    if_ = i.to(torch.float32)
    df = d.to(torch.float32)
    sf = s.to(torch.float32)
    mex = mf + eq.to(torch.float32) + x.to(torch.float32)
    mm = nm.to(torch.float32) - (if_ + df)
    clip_ok = sf <= clip_percent * (mex + if_ + sf)
    iden_ok = (mex - mm) >= iden_percent * (mex + if_ + df)
    return base & clip_ok & iden_ok
