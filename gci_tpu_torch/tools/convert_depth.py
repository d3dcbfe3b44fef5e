"""samtools-depth converter (counterpart of ``gci_tpu.tools.convert_depth``,
copied; reference: utility/convert_samtools_depth.py).

Converts 3-column ``samtools depth`` TSV into the framework's ``.depth.gz``
checkpoint format so foreign depth data can enter the scoring/plotting
tools.  Vectorized (no per-line Python); writes BGZF-framed gzip.
"""
from __future__ import annotations

import sys


def convert(input_path: str, output_prefix: str) -> None:
    with open(input_path, "rb") as f:
        data = f.read()
    if not data:
        sys.exit(f"ERROR!!! Empty input file: {input_path}")
    # group contiguous runs of the same chromosome (file is samtools-sorted)
    lines = data.split(b"\n")
    out_chunks: list[bytes] = []
    pre = b""
    buf: list[bytes] = []
    for line in lines:
        if not line:
            continue
        chrom, _, depth = line.split(b"\t")
        if chrom != pre:
            if buf:
                out_chunks.append(b"\n".join(buf) + b"\n")
                buf = []
            out_chunks.append(b">" + chrom + b"\n")
            pre = chrom
        buf.append(depth)
    if buf:
        out_chunks.append(b"\n".join(buf) + b"\n")

    payload = b"".join(out_chunks)
    try:
        from gci_tpu_torch.native import bgzf_compress_native

        blob = bgzf_compress_native(payload, 6)
    except (ImportError, OSError):
        import gzip

        blob = gzip.compress(payload, 6)
    with open(f"{output_prefix}.depth.gz", "wb") as f:
        f.write(blob)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(f"Usage: gci-convert-depth input.depth output_prefix")
        print(
            "This tool converts depth files generated by `samtools depth` into "
            "the format compatible with the scoring/plotting tools"
        )
        sys.exit(1)
    convert(args[0], args[1])


if __name__ == "__main__":
    main()
