"""gci_tpu_torch — the genome continuity engine on PyTorch and CUDA.

The port of ``gci_tpu`` (JAX on a TPU) to one NVIDIA H100.  It mirrors
``gci_tpu``'s module names and layout and imports nothing of it: the host
layers (BAM/PAF/FASTA readers, the C++ codec, filters, curation, interval,
score and plot code) are the port's own copies, and every module whose work
reaches JAX is ported:

  device.py         torch device resolution (always explicit, never global)
  kernels.py        nvcc build + ctypes binding of csrc/scan.cu, launch counts
  native/           ctypes binding of csrc/gci_native.cpp, the host codec
  depth/scan.py     the scan kernels' wrappers and plain versions
  depth/device.py   host helpers of the device path, the device scatter,
                    the sharded (dp, gp) programs
  depth/fused.py    ``DeviceDepth``: the single-GPU resident depth
  depth/streamed.py chunked scans for genomes past the resident path
  depth/sharded.py  ``ShardedDepth``: the genome axis over a (dp, gp) mesh
  parallel/         the mesh of positions and the multi-process runtime
                    (``torch.distributed``: NCCL on the GPU, gloo on the host)
  pipeline.py, cli.py, io/, reports/, score/, utils/
                    counterparts of the JAX package's seams

``import gci_tpu_torch`` needs neither CUDA nor nvcc: kernels build and load
on their first launch with a CUDA tensor, the host codec on its first use.
"""

__version__ = "0.1.0"
