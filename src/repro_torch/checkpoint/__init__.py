from repro_torch.checkpoint.ckpt import CheckpointManager, restore_pytree, save_pytree  # noqa: F401
