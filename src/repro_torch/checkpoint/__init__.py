"""Checkpoints that the JAX package's ``repro.checkpoint`` also reads."""
from repro_torch.checkpoint.ckpt import (latest_step, load_opt_state,  # noqa: F401
                                         restore_checkpoint,
                                         save_checkpoint)
