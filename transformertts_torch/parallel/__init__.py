"""The training and serving mesh, the counterpart of ``transformertts_tpu/parallel``."""
from transformertts_torch.parallel.mesh import (MeshConfig, ProcessMesh, make_mesh,
                                                maybe_initialize_distributed,
                                                pad_batch_to_multiple, shard_batch)

__all__ = ['MeshConfig', 'ProcessMesh', 'make_mesh', 'maybe_initialize_distributed',
           'pad_batch_to_multiple', 'shard_batch']
