"""hinge_tpu — a JAX long-read OLC assembler with HINGE's capabilities.

A from-scratch re-design of the HINGE assembly pipeline
(filter -> maximal -> layout -> clip -> draft-path -> draft -> consensus -> gfa)
for JAX/XLA on an accelerator (an NVIDIA GPU; tests run on the CPU backend):

* overlap records live in a columnar struct-of-arrays (`hinge_tpu.data.overlaps`)
  instead of per-record C++ objects,
* the pileup / coverage / mask / repeat-annotation inner loops run as dense
  vectorized kernels over (read, bin) grids (`hinge_tpu.ops`),
* overlap classification and trace-point walks are elementwise integer kernels,
* the small assembly graph is pruned on the host (`hinge_tpu.graph`),
* draft/consensus use batched banded alignment + pileup voting kernels,
* multi-chip scaling shards overlap records by A-read id over a
  `jax.sharding.Mesh` (`hinge_tpu.parallel`).

Reference behavior: HingeAssembler/HINGE (see SURVEY.md for a full map).
"""

__version__ = "0.1.0"

from hinge_tpu.config import Config  # noqa: F401
