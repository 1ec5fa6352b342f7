"""Multi-GPU execution: the (data, edge) mesh over torch.distributed
ranks (`mesh.py`), the sharded train step (`shard.py`), torchrun's
runtime (`runtime.py`) and local worker processes (`launch.py`).

``make_dp_train_step`` is imported on first use: `shard.py` imports the
model, whose layers import `mesh.py` from this package."""

from redgnn_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "make_dp_train_step"]


def __getattr__(name):
    if name == "make_dp_train_step":
        from redgnn_tpu_torch.parallel.shard import make_dp_train_step

        return make_dp_train_step
    raise AttributeError(name)
