from yololite_tpu_torch.models.backbones.zoo import (  # noqa: F401
    BACKBONES, backbone_feature_info, build_backbone,
)
