"""Production and host meshes on ``torch.distributed`` (port of
``repro.launch.mesh``).

Functions, never module-level meshes, so importing this module touches no
process group. A ``DeviceMesh`` needs the default process group to be
initialized with one rank per mesh position: the dry run
(``repro_torch.launch.dryrun``) starts a fake group of 256 or 512 ranks in
its own process, a real deployment starts one rank per GPU
(``repro_torch.launch.distributed``).

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet; the card
``nvidia-smi`` reports as "NVIDIA H100 80GB HBM3" at its 700 W limit), the
peaks the port's roofline (``repro_torch.analysis.roofline``) divides by.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple


from repro_torch.device import DeviceLike, resolve_device

PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12              # HBM3 bytes/s per GPU
# NVLink bytes/s each way per GPU (18 links of 25 GB/s); it plays the role
# the reference's ICI_BW (bytes/s per TPU link) plays in the collective term
NVLINK_BW = 450e9


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over the default process group's ranks
    in order, its dims named ``axis_names``, on the card unless the caller
    names the CPU (``device="cpu"``: gloo or the fake group). The group's
    world size must equal the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: start one first "
            "(repro_torch.launch.distributed.maybe_initialize_distributed, or "
            "torch.distributed.init_process_group)")
    n = 1
    for d in shape:
        n *= d
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model"). A 16-wide model axis spans
    two 8-GPU NVLink domains of H100 hosts."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None):
    """A 1 x 1 mesh with the production axis names, over a process group of
    one rank, on the card unless the caller names the CPU."""
    return make_mesh((1, 1), ("data", "model"), device)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any mesh-like object with
    ``axis_names`` and a ``shape`` dict (the reference tests' stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a == "model")


def axis_size(mesh, names) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "make_mesh", "make_production_mesh",
           "make_host_mesh", "axis_sizes", "data_axes", "model_axes", "axis_size"]
