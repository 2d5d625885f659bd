from yololite_tpu_torch.config.config import (  # noqa: F401
    deep_merge, parse_yaml, read_yaml, resolve_model_arg,
)
