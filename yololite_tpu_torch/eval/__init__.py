from yololite_tpu_torch.eval.coco import COCOEvaluator, coco_eval_from_lists
from yololite_tpu_torch.eval.confusion import create_confusion_matrix
from yololite_tpu_torch.eval.evaluate import evaluate_model
from yololite_tpu_torch.eval.plots import plot_metrics
from yololite_tpu_torch.eval.prf1 import build_curves_from_coco

__all__ = ["COCOEvaluator", "coco_eval_from_lists", "build_curves_from_coco",
           "create_confusion_matrix", "evaluate_model", "plot_metrics"]
