from yololite_tpu_torch.losses.simota import LossConfig, SimOTALoss

__all__ = ["LossConfig", "SimOTALoss"]
