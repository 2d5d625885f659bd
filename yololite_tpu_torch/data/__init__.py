from yololite_tpu_torch.data.augment import ValTransform
from yololite_tpu_torch.data.dataset import YoloDataset, list_images, parse_yolo_label_file
from yololite_tpu_torch.data.loader import DataLoader, collate

__all__ = ["YoloDataset", "DataLoader", "collate", "ValTransform",
           "parse_yolo_label_file", "list_images"]
