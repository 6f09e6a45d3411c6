from repro_torch.checkpoint.ckpt import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)
