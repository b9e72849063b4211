"""The training mesh over the ranks of a process group (the port of
``eksml_tpu/parallel/mesh.py``: ``divisors``, ``slice_groups`` and
``build_mesh``).

The reference lays TPU devices on a ``jax.sharding.Mesh``; the port lays
ranks (one per GPU) on a ``torch.distributed.DeviceMesh``.  Ranks are
slice-major by construction (``parallel/distributed.py``: the host rank
is slice-major and each host's GPUs are consecutive), so the row-major
layout of ``init_device_mesh`` puts the leading axis across slices
(nodes) and every trailing axis inside one.  The TPU slice inventory
(``TPU.TOPOLOGY`` names such as ``v5e-32``) has no GPU meaning: a
non-empty ``TPU.TOPOLOGY`` raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

#: where the TPU-topology half of the reference's mesh module is planned
TOPOLOGY_ITEM = "ROADMAP.md Queue 1, item 4 (multi-GPU)"


def divisors(n: int) -> list:
    """Valid axis sizes for ``n`` devices — the payload of every "axis
    size does not divide" error (one definition for build_mesh and
    sharding.plan_mesh)."""
    return [d for d in range(1, n + 1) if n % d == 0]


def check_topology(topology: str) -> None:
    """Refuse a TPU slice name: the GPU port lays out ranks, not TPU
    chips (``TPU.TOPOLOGY`` stays empty)."""
    if topology:
        raise ValueError(
            f"TPU.TOPOLOGY={topology!r} names a TPU slice; the PyTorch/CUDA "
            "port runs one process per GPU and takes its layout from the "
            "process group (leave TPU.TOPOLOGY empty; the TPU-topology "
            f"lookup is not ported, {TOPOLOGY_ITEM})")


def slice_groups(world_size: int, num_slices: int = 1
                 ) -> Optional[Dict[int, List[int]]]:
    """Ranks by slice (node): ``{slice: [ranks]}`` in slice order, or
    ``None`` for a single slice.  Ranks are slice-major, so slice ``s``
    holds ranks ``[s·k, (s+1)·k)`` with ``k = world_size / num_slices``."""
    if num_slices <= 1:
        return None
    if world_size % num_slices:
        raise ValueError(f"{world_size} ranks do not split into "
                         f"num_slices={num_slices}")
    k = world_size // num_slices
    return {s: list(range(s * k, (s + 1) * k)) for s in range(num_slices)}


def mesh_shape_for(mesh_shape: Sequence[int], axis_names: Sequence[str],
                   world_size: int, num_slices: int = 1
                   ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Validated ``(shape, axes)`` of the mesh over ``world_size`` ranks:
    the default puts every rank on the leading (data) axis; the
    reference's checks name the knobs at fault."""
    axis_names = tuple(axis_names)
    shape = tuple(int(s) for s in mesh_shape)
    if not shape:
        shape = (world_size,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} entries for "
            f"{len(axis_names)} axes {axis_names} — TPU.MESH_SHAPE and "
            "TPU.MESH_AXES must be the same length (one size per axis)")
    if any(s < 1 for s in shape):
        raise ValueError(
            f"mesh shape {shape}: every axis size must be >= 1 (axes "
            f"{axis_names}); use 1 for an unused axis")
    need = 1
    for s in shape:
        need *= s
    if need != world_size:
        # one process per GPU: a subset mesh would leave ranks out of
        # every collective (a hang at the first one)
        raise ValueError(
            f"mesh shape {shape} over axes {axis_names} covers {need} "
            f"rank(s), the process group has {world_size} — the product "
            "of the axis sizes (TPU.MESH_SHAPE / "
            "TRAIN.SHARDING.FSDP_AXIS_SIZE) must equal the world size")
    if num_slices > 1:
        slice_groups(world_size, num_slices)   # raises when uneven
        if axis_names[0] == "slice":
            if shape[0] != num_slices:
                raise ValueError(
                    f"slice axis size {shape[0]} must equal the slice "
                    f"count ({num_slices}): the 'slice' mesh axis is the "
                    "inter-node decomposition itself")
        elif shape[0] % num_slices:
            raise ValueError(
                f"data axis {shape[0]} does not split over {num_slices} "
                f"slices; the trailing axes {axis_names[1:]} (sizes "
                f"{shape[1:]}) must divide each slice's rank count")
    return shape, axis_names


def build_mesh(mesh_shape: Sequence[int] = (),
               axis_names: Sequence[str] = ("data", "model"),
               num_slices: int = 1, device_type: str = "cuda"):
    """The ``DeviceMesh`` of the live process group (every rank calls
    it): ``init_device_mesh(device_type, shape, mesh_dim_names=axes)``
    over slice-major ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group "
                           "(parallel/distributed.initialize_from_env)")
    shape, axes = mesh_shape_for(mesh_shape, axis_names,
                                 dist.get_world_size(), num_slices)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
