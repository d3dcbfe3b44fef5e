"""gci_tpu_torch — the genome continuity engine on PyTorch and CUDA.

The port of ``gci_tpu`` (JAX on a TPU) to one NVIDIA H100.  It mirrors
``gci_tpu``'s module names and reuses its host layers (BAM/PAF/FASTA
readers, the C++ codecs, filters, curation, interval and score math) by
import; what it ports is every module whose call reaches JAX:

  device.py         torch device resolution (always explicit, never global)
  kernels.py        nvcc build + ctypes binding of csrc/scan.cu, launch counts
  depth/scan.py     the two scan kernels' wrappers and plain versions
  depth/device.py   host helpers of the device path, device prefix sum
  depth/fused.py    ``DeviceDepth``: the single-GPU resident depth
  pipeline.py, cli.py, io/, reports/, score/, utils/, parallel/
                    single-process counterparts of the JAX package's seams

``import gci_tpu_torch`` needs neither CUDA nor nvcc: kernels build and load
on their first launch with a CUDA tensor.
"""

__version__ = "0.1.0"
