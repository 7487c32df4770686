"""The serving mesh, the Megatron sharding rules and the follower ranks."""

from vgate_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    MeshPlan,
    build_mesh,
    resolve_plan,
)

__all__ = ["MESH_AXES", "Mesh", "MeshPlan", "build_mesh", "resolve_plan"]
