from hugs_tpu_torch.cfg.config import (
    Config, check_supported, default_config, get_cfg_items, load_config,
)
