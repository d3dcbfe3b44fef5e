"""Main CLI of the port (counterpart of ``gci_tpu.cli``).

The flag surface, defaults, validation messages and argument echo are
``gci_tpu.cli``'s own, reused by import.  What this slice does not run yet
exits with a "not yet ported" message: the sharded and streamed backends,
``--mesh``, the multi-host flags and ``--profile-trace``.  ``--device
device`` needs CUDA and exits with an error without it; it never falls back
to the CPU.

    python -m gci_tpu_torch.cli -r ref.fa --hifi x.bam [--nano y.bam] --device device
"""
from __future__ import annotations

import sys

from gci_tpu.cli import build_parser, validate_args

# flags whose feature belongs to a later slice
_NOT_PORTED_FLAGS = (
    ("--mesh", "mesh"),
    ("--coordinator", "coordinator"),
    ("--num-processes", "num_processes"),
    ("--process-id", "process_id"),
    ("--profile-trace", "profile_trace"),
)


def _not_ported(what: str):
    sys.exit(f"ERROR!!! {what} is not yet ported to gci_tpu_torch")


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    parser.description = (
        "A GPU-native program for assessing the T2T genome (PyTorch/CUDA)"
    )
    args = vars(parser.parse_args(argv))
    if len(sys.argv) == 1 and argv is None:
        parser.print_help()
        sys.exit()
    validate_args(args)
    for flag, key in _NOT_PORTED_FLAGS:
        if args.pop(key) is not None:
            _not_ported(flag)
    if args["depth_backend"] in ("sharded", "streamed"):
        _not_ported(f"--device {args['depth_backend']}")

    from gci_tpu_torch.pipeline import resolve_backend, run_gci

    try:
        backend, torch_device = resolve_backend(args["depth_backend"])
    except RuntimeError as exc:
        sys.exit(f"ERROR!!! --device {args['depth_backend']}: {exc}")
    print(f"Used arguments:{args}")
    args["depth_backend"] = backend
    run_gci(**args, torch_device=torch_device)


if __name__ == "__main__":
    main()
