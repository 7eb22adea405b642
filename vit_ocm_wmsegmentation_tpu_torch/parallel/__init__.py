"""Multi-device paths of the port on ``torch.distributed``: one process a
GPU (``torchrun``), meshes of process groups, the collectives, the FSDP and
Megatron sharding rules (``mesh``), GPipe pipeline parallelism (``pp``) and
the multi-rank dry run (``dryrun``).

Counterpart of ``vit_ocm_wmsegmentation_tpu/parallel``. As there, ``pp`` and
``dryrun`` are imported explicitly (``from ..parallel import pp``): they pull
in the models, and this package stays light for processes that only join a
group.
"""

from .mesh import (
    Mesh,
    ParamLayout,
    Shard,
    TensorParallel,
    data_parallel_sharding,
    fsdp_param_sharding,
    init_distributed,
    is_main_process,
    local_rows,
    make_mesh,
    on_main_process,
    param_layout,
    rank_device,
    vit_param_sharding,
)
