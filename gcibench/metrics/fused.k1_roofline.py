"""K1's share of its bandwidth bound, from the device trace.

K1 is the packed-word scan of the resident build (``gci_packed_scan`` in
``gci_tpu_torch/csrc/scan.cu``), one call per read type of an assessment.
A call launches three kernels: ``tile_sums_kernel`` (each tile's sum),
``tile_carry_kernel`` (the tiles' carries) and ``packed_scan_tiles_kernel``
(the scan and its epilogue); its time is theirs together.  No other call
of the resident packed path launches the first two; a cell that also runs
the flags scan or the edge scans, which share them, would need this
reader revised.

The bound is ``BYTES_PER_SLOT`` a genome slot (the int32 event word read
once, the int32 depth and the flag byte written once) at the card's HBM
bandwidth (``peaks.json``); the share is that bound over K1's summed device
time per completed assessment, found by the kernels' names among the
trace's device operations.  None without a trace, and unless all three
kernels are there: the trace summary keeps only its largest operations,
so a pass that dropped out of it shows as a missing reading, never as a
higher share.
"""
UNIT = "%"
KERNEL = "packed_scan_tiles_kernel"
PASSES = ("tile_sums_kernel", "tile_carry_kernel")
BYTES_PER_SLOT = 9


def bytes_per_call(slots: int) -> int:
    """The bytes one call of K1 over ``slots`` genome slots must move."""
    return BYTES_PER_SLOT * slots


def read(run):
    bw = run.peaks.get("hbm_bytes_per_s")
    if run.trace is None or not bw or not run.completed:
        return None
    ops = run.trace.device_ops
    kernels = (KERNEL, *PASSES)
    if not all(any(k in name for name, _ in ops) for k in kernels):
        return None
    k1_s = sum(t for name, t in ops if any(k in name for k in kernels))
    calls = len(run.mix["read_types"])
    bound_s = calls * bytes_per_call(run.slots) / bw
    return 100 * bound_s / (k1_s / run.completed)
