"""GridDescriptor — binds a :class:`GridConfig` to a ``torch.device`` and,
for more than one rank, to a ``torch.distributed`` DeviceMesh.

The analog of ``cudecompGridDescCreate`` (``src/cudecomp.cc:1039-1269``):
the reference's row and column communicators become the process groups of
the mesh dims ``('pr', 'pc')``.  X<->Y transposes exchange over ``pr`` (the
reference's *column* communicator, ``transpose.h:227``), Y<->Z over ``pc``
(the *row* communicator).  Each rank holds its own local pencil tensor on
the grid's device; a ``(1, 1)`` grid needs no process group at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch.config import GridConfig
from cudecomp_tpu_torch.geometry import PencilInfo, Triple
from cudecomp_tpu_torch.parallel.mesh import (build_mesh, check_cards,
                                              world_hosts)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device gets its index and
    raises when CUDA is not available (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is not "
                               f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class GridDescriptor:
    """A decomposition bound to a device and (for Pr*Pc > 1) a mesh.

    Attributes:
      config: the grid configuration, with explicit pdims.
      device: where this rank's pencils live.
      mesh: DeviceMesh holding the decomposition dims; None for (1, 1).
        A dim of size 1 may be absent from the mesh.
      axis_names: mesh dim names for (pr, pc).
      hosts: the host name of each global rank (``mesh.world_hosts``),
        which sets ``ring_hier``'s fast groups; None where unknown (a
        caller's mesh), and then ``ring_hier`` runs a flat ring.
    """

    config: GridConfig
    device: torch.device
    mesh: Optional[object] = None
    axis_names: Tuple[str, str] = ("pr", "pc")
    hosts: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        cfg = self.config
        if cfg.autotune_pdims:
            raise ValueError("GridDescriptor requires explicit pdims")
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.mesh is None:
            if cfg.pdims != (1, 1):
                raise ValueError(f"pdims {cfg.pdims} need a DeviceMesh")
            return
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"mesh device type {self.mesh.device_type!r} "
                             f"!= grid device {self.device}")
        names = self.mesh.mesh_dim_names or ()
        for name, pd in zip(self.axis_names, cfg.pdims):
            if name not in names:
                if pd == 1:
                    continue  # a size-1 axis never exchanges
                raise ValueError(f"mesh has no dim {name!r}; dims: {names}")
            size = self.mesh.size(names.index(name))
            if size != pd:
                raise ValueError(
                    f"mesh dim {name!r} has size {size}, config expects {pd}")

    # -- geometry passthroughs --------------------------------------------------

    @property
    def pdims(self) -> Tuple[int, int]:
        return self.config.pdims

    @property
    def gdims(self) -> Triple:
        return self.config.gdims

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (pr, pc) process-grid coordinates."""
        if self.mesh is None:
            return (0, 0)
        names = self.mesh.mesh_dim_names
        mine = self.mesh.get_coordinate()
        if mine is None:
            raise RuntimeError("this rank is not part of the grid's mesh")
        return tuple(mine[names.index(n)] if n in names else 0
                     for n in self.axis_names)  # type: ignore[return-value]

    @property
    def rank(self) -> int:
        """This rank's linear rank in the process grid."""
        return geometry.rank_of_coords(self.config, *self.coords)

    def group(self, name: str):
        """Process group of mesh dim ``name``."""
        return self.mesh.get_group(name)

    def pencil_info(self, axis: int, rank: Optional[int] = None,
                    coords: Optional[Tuple[int, int]] = None,
                    halo_extents=None, padding=None) -> PencilInfo:
        """Pencil info (``cudecompGetPencilInfo``); this rank's by default."""
        if coords is None:
            coords = (self.coords if rank is None
                      else geometry.coords_of_rank(self.config, rank))
        return geometry.get_pencil_info(self.config, axis, coords,
                                        halo_extents=halo_extents,
                                        padding=padding)

    def shifted_rank(self, axis: int, dim: int, displacement: int,
                     periodic: bool, rank: int) -> int:
        return geometry.get_shifted_rank(self.config, axis, dim, displacement,
                                         periodic, rank)

    def buffer_shape(self, axis: int, halo_extents=None, padding=None) -> Triple:
        """Shape of this rank's local pencil tensor (uniform over ranks)."""
        return geometry.pencil_buffer_shape(self.config, axis, halo_extents,
                                            padding)

    def global_shape(self, axis: int, halo_extents=None, padding=None) -> Triple:
        return geometry.global_buffer_shape(self.config, axis, halo_extents,
                                            padding)

    def comm_axis_name(self, ax: int, dir_: int) -> str:
        """Mesh dim over which the transpose (ax -> ax+dir) exchanges:
        X<->Y over pr, Y<->Z over pc (``transpose.h:222-228``)."""
        lo_axis = min(ax, ax + dir_)
        return self.axis_names[0] if lo_axis == 0 else self.axis_names[1]


def make_grid(config: GridConfig, device, mesh=None,
              axis_names: Tuple[str, str] = ("pr", "pc"),
              autotune_options=None, example_dtype=None) -> GridDescriptor:
    """Create a GridDescriptor (``cudecompGridDescCreate``).

    ``device`` is where this rank's pencils live.  With ``Pr * Pc > 1`` and
    no ``mesh``, a mesh over the whole default process group is built in
    the configured rank order (every rank must call).  Ranks may share a
    card over a gloo default group (``parallel/mesh.py``: the rule, and
    ``check_cards``, which refuses NCCL there).

    With ``pdims (0, 0)``, or ``autotune_options`` that sweep the transpose
    method, the autotuner (``autotune.autotune``) times the candidates on
    ``device`` with ``example_dtype`` trial data and returns the winner's
    grid (``src/cudecomp.cc:1200-1211``); every rank must call.
    """
    if config.autotune_pdims or (
            autotune_options is not None
            and autotune_options.autotune_transpose_method):
        if mesh is not None:
            # the sweep builds its own candidate meshes over the world; a
            # caller's mesh would be dropped in silence
            raise ValueError(
                "make_grid: autotuning with an explicit mesh is not "
                "supported; autotune first and bind the winning config to "
                "your mesh with GridDescriptor(config=result.grid.config, "
                "device=..., mesh=mesh)")
        from cudecomp_tpu_torch.autotune import autotune
        return autotune(config, device, options=autotune_options,
                        axis_names=axis_names, dtype=example_dtype).grid
    device = resolve_device(device)
    hosts = None
    if mesh is None and config.pdims != (1, 1):
        check_cards(device)
        mesh = build_mesh(config.pdims, device.type, config.rank_order,
                          axis_names)
        hosts = world_hosts()
    return GridDescriptor(config=config, device=device, mesh=mesh,
                          axis_names=axis_names, hosts=hosts)


def clear_plan_caches() -> None:
    """Drop every cached transpose plan and stencil apply (the reference
    pairs its plan cache with grid-descriptor destroy, ``graph.h:37-51``).
    Plans hold their grid, and through it the mesh and its process
    groups."""
    from cudecomp_tpu_torch.ops import stencil, transpose
    transpose._build_transpose_fn.cache_clear()
    stencil._stencil_apply_fn.cache_clear()
    stencil._diff_apply_fn.cache_clear()


def init(device="cuda") -> torch.device:
    """``cudecompInit`` analog (cudecomp.h:249): checks that ``device`` is
    usable and returns it resolved.  Process groups are the caller's
    (``torch.distributed.init_process_group``)."""
    return resolve_device(device)


def finalize() -> None:
    """``cudecompFinalize`` analog (cudecomp.h:268): drops cached plans."""
    clear_plan_caches()
