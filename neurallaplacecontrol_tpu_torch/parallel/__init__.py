"""Multi-process orchestration: the process group, the grid's split by
process and the out-of-band barrier. The meshes and sharded steps of the JAX
package's ``parallel.sharding`` are not ported yet."""

from .multihost import barrier, initialize, process_count, process_index, process_slice  # noqa: F401
