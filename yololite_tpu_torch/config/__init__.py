from yololite_tpu_torch.config.config import (  # noqa: F401
    SAVE_BY_KEYS, apply_overrides, build_argparser, deep_merge, dump_yaml, load_configs,
    parse_yaml, read_yaml, resolve_model_arg, save_merged_config,
)
