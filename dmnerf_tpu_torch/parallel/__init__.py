from dmnerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step, shard_batch

__all__ = ["make_mesh", "make_sharded_train_step", "shard_batch"]
