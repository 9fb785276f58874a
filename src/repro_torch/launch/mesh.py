"""Device meshes (the twin of ``src/repro/launch/mesh.py``).

`make_local_mesh` builds a ``torch.distributed`` `DeviceMesh` over the
current world; the production meshes are data (`PRODUCTION_MESHES`) that
a fake world of 256 or 512 ranks can take.  Importing this module touches
no device and no process group: the caller initialises the world (its
address, size and rank) before it asks for a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

#: the reference's production meshes: one pod, (data, model) = (16, 16),
#: 256 devices; two pods, (pod, data, model) = (2, 16, 16), 512 devices
PRODUCTION_MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the single-pod or the two-pod mesh."""
    return PRODUCTION_MESHES["multi_pod" if multi_pod else "pod"]


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """A (world // model_parallel, model_parallel) mesh named ("data",
    "model") over the initialised world, on ``device_type``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"world {n} does not divide by model_parallel "
                         f"{model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 80GB HBM3 (SXM5, 700 W power limit) datasheet figures, per
# card, for the roofline: dense bf16 tensor-core peak, HBM3 bandwidth, and
# NVLink 4 (18 links, 900 GB/s both directions together).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW_PER_LINK = 25e9         # bytes/s per link and direction
NVLINK_LINKS = 18
# The same datasheet's other rates, for the kernels' bounds: fp32 outside
# the tensor cores, dense TF32 on them, and the SFUs' exps (16 per clock
# per SM, CUDA C++ Programming Guide, compute capability 9.0; 132 SMs at
# the 1,980 MHz boost clock).
PEAK_FLOPS_FP32 = 67e12           # FLOP/s
PEAK_FLOPS_TF32 = 495e12          # FLOP/s
SFU_OPS_PER_S = 16 * 132 * 1.98e9
