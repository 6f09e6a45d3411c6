from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                                all_configs, get_config, reduced, register)
